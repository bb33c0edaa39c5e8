"""Learning-rate schedules (port of ``scann_tpu/train/schedules.py``).

The two schedules the reference trains with (``scann_model.py:199-214``),
as plain Python floats: the learning rate is computed on the host once per
step (cosine) or per epoch (SGDR).

- ``cosine``: Keras ``CosineDecay(lr, 0.5 * steps_per_epoch * epochs,
  alpha=min_lr/lr)`` composed with the Keras ``Adam(decay=1e-5)``
  inverse-time factor ``1 / (1 + decay * step)``.
- ``sgdr``: warm restarts driven per epoch, with the reference's stateful
  behaviour (``custom_layers.py:105-179``): restarts begin once val MAE
  crosses a trigger, the period doubles each cycle (t0=50, tmult=2), and
  the warmup peak is compressed toward the current lr on every val
  improvement.
"""

from __future__ import annotations

import math
from typing import Callable


def make_cosine_lr(lr: float, min_lr: float, steps_per_epoch: int, epochs: int,
                   adam_decay: float = 1e-5) -> Callable[[int], float]:
    """step -> learning rate: cosine decay times inverse-time decay."""
    decay_steps = max(1.0, 0.5 * steps_per_epoch * epochs)
    alpha = min_lr / lr

    def lr_fn(step: int) -> float:
        t = min(float(step), decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        base = lr * ((1.0 - alpha) * cos + alpha)
        return base / (1.0 + adam_decay * float(step))

    return lr_fn


class SGDRSchedule:
    """Host-side SGDR with the val-MAE trigger and peak compression.

    Call ``epoch_begin()`` for the lr of this epoch and ``epoch_end(val_mae)``
    after validation. Reference defaults (``scann_model.py:181-189``):
    t0=50, tmult=2, compression=1.2, trigger_val_mae=300 (with standardized
    targets this triggers at once, as in the reference).
    """

    _STATE_FIELDS = ("triggered", "lr", "lr_warmup_current", "lr_warmup_next",
                     "ti", "tcur", "best_val_mae")

    def __init__(self, lr_max: float, lr_min: float, t0: int = 50, tmult: int = 2,
                 lr_max_compression: float = 1.2, trigger_val_mae: float = 300.0):
        self.lr_max = lr_max
        self.lr_min = lr_min
        self.t0 = t0
        self.tmult = tmult
        self.compression = lr_max_compression
        self.trigger_val_mae = trigger_val_mae
        self.reset()

    def reset(self):
        self.triggered = False
        self.lr = self.lr_max
        self.lr_warmup_current = self.lr_max
        self.lr_warmup_next = self.lr_max
        self.ti = self.t0
        self.tcur = 1
        self.best_val_mae = math.inf

    def epoch_begin(self) -> float:
        if not self.triggered:
            return self.lr
        self.tcur += 1
        if self.tcur > self.ti:
            self.ti = int(self.tmult * self.ti)
            self.tcur = 1
            self.lr_warmup_current = self.lr_warmup_next
        self.lr = self.lr_min + (self.lr_warmup_current - self.lr_min) * (
            1.0 + math.cos(self.tcur / self.ti * math.pi)) / 2.0
        return self.lr

    def epoch_end(self, val_mae: float):
        if not self.triggered and val_mae <= self.trigger_val_mae:
            self.triggered = True
        if self.triggered and val_mae < self.best_val_mae:
            self.best_val_mae = val_mae
            if self.compression > 0:
                self.lr_warmup_next = max(self.lr_warmup_current / self.compression, self.lr)
            else:
                self.lr_warmup_next = self.lr

    def state_dict(self) -> dict:
        """The whole schedule state (a faithful resume needs all of it: the
        peak compression depends on the val MAE history)."""
        return {f"sgdr_{f}": float(getattr(self, f)) for f in self._STATE_FIELDS}

    def load_state_dict(self, d: dict) -> None:
        self.triggered = bool(float(d["sgdr_triggered"]))
        self.lr = float(d["sgdr_lr"])
        self.lr_warmup_current = float(d["sgdr_lr_warmup_current"])
        self.lr_warmup_next = float(d["sgdr_lr_warmup_next"])
        self.ti = int(d["sgdr_ti"])
        self.tcur = int(d["sgdr_tcur"])
        self.best_val_mae = float(d["sgdr_best_val_mae"])
