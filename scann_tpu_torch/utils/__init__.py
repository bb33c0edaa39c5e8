"""Timing spans, traces, the FLOP model and the measured roofline of the port."""

from scann_tpu_torch.utils.profiling import Timer, trace  # noqa: F401
