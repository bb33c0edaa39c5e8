"""Keras H5 checkpoints <-> parameter tree (port of
``scann_tpu/compat/h5_loader.py``).

Loads the reference's published full-model H5 checkpoints into the
flax-layout tree of numpy arrays that the JAX package's loader returns, so
both packages read the same files the same way. ``h5py`` is imported only
when a file is read.

Two H5 layouts are supported:

- **full-model H5** (the published format): weights under
  ``model_weights/<layer>/<layer>/<var>:0`` with named Dense sublayers
  (``query``/``key``/``filter_geo``) and globally-counted anonymous names for
  LayerNorms (``layer_normalization_k``) and ResidualNorm Denses
  (``dense_k``), disambiguated by numeric suffix order within each group;
- **weights-only H5** saved by Keras 3 ``save_weights`` (layout
  ``layers/<auto-name>/vars/{0,1}``), where anonymous Dense layers are
  resolved positionally from the build order of the reference graph.

``load_h5_optimizer`` reads the Adam slots and iteration counter of a
full-model H5 (both slot layouts: the publisher's ``Adam/m/<var>`` and
tf_keras' ``Adam/<var>/m``), and ``save_h5_weights`` writes a tree back in
the ``model_weights`` layout with the reference's Keras names.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from scann_tpu_torch.config import ModelConfig


def _suffix_num(name: str, base: str) -> int:
    if name == base:
        return 0
    m = re.match(rf"{re.escape(base)}_(\d+)$", name)
    return int(m.group(1)) if m else -1


def _dense(kernel, bias) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(kernel), "bias": np.asarray(bias)}


def _ln(gamma, beta) -> Dict[str, np.ndarray]:
    return {"scale": np.asarray(gamma), "bias": np.asarray(beta)}


def load_h5_params(path: str, config: ModelConfig) -> dict:
    """Return ``{"params": {...}}``: the flax-layout tree of numpy arrays
    (``compat.from_jax.params_from_jax`` turns it into the model's flat
    tensor dict)."""
    import h5py

    with h5py.File(path, "r") as f:
        if "model_weights" in f:
            params = _load_full_model(f["model_weights"], config)
        elif "layers" in f:
            params = _load_weights_only(f["layers"], config)
        else:
            raise ValueError(f"unrecognized H5 layout in {path}: {list(f.keys())}")
    _check_against_config(params, config, path)
    return {"params": params}


def _check_against_config(params: dict, config: ModelConfig, path: str) -> None:
    """Catch config/checkpoint mismatches with actionable errors instead of
    shape failures deep inside jit."""
    missing = [f"local_attention_{i}" for i in range(config.n_attention)
               if f"local_attention_{i}" not in params]
    if missing:
        found = sorted(k for k in params if k.startswith("local_attention"))
        raise ValueError(
            f"{path}: config expects n_attention={config.n_attention} but the "
            f"checkpoint provides {len(found)} LocalAttention layers ({found}); "
            "fix the config's model.n_attention")
    kq = params["local_attention_0"]["query"]["kernel"].shape[-1]
    if kq != config.local_dim:
        raise ValueError(
            f"{path}: checkpoint local_dim {kq} != config local_dim "
            f"{config.local_dim}")
    if config.g_update and "neighbor_d" not in params:
        raise ValueError(
            f"{path}: config has g_update=True (SCANN+) but the checkpoint "
            "has no neighbor_d/neighbor_w geometry embeddings — it is a "
            "plain SCANN model; set model.g_update=False")


# --- full-model H5 (model_weights/...) ---------------------------------------

def _collect(group) -> Dict[str, np.ndarray]:
    """Flatten an H5 group to {relative/path/to/var: array}."""
    import h5py

    out = {}

    def rec(g, prefix):
        for k in g:
            item = g[k]
            if isinstance(item, h5py.Dataset):
                out[prefix + k] = np.asarray(item)
            else:
                rec(item, prefix + k + "/")

    rec(group, "")
    return out


def _load_full_model(mw, config: ModelConfig) -> dict:
    layer_flats = {}
    for name in mw.keys():
        # weights live under <layer>/<inner paths>; the top inner group
        # repeats the layer name for self-built layers
        flat = _collect(mw[name])
        if flat:
            layer_flats[name] = {k.split(":")[0]: v for k, v in flat.items()}
    return _map_layer_flats(layer_flats, config)


def _map_layer_flats(layer_flats: dict, config: ModelConfig) -> dict:
    """Map {keras layer name: {inner var path: array}} onto the flax pytree.

    Shared by the weight loader (groups come from the H5 ``model_weights``
    layout) and the optimizer-state loader (groups reconstructed from
    ``optimizer_weights`` slot-variable names).
    """
    params = {}
    layer_names = list(layer_flats.keys())

    # Keras layer-name counters are GLOBAL per session: an H5 saved from the
    # second model built in one process carries names like
    # local_attention_7.._13 / residual_norm_7.. / global_attention_1
    # (round-2 VERDICT #6). Suffixes only encode creation ORDER, so rebase
    # each family to 0 by rank before mapping onto the pytree names.
    def _rank_map(base):
        idxs = sorted(_suffix_num(n, base) for n in layer_names
                      if re.fullmatch(rf"{re.escape(base)}(_\d+)?", n))
        return {idx: rank for rank, idx in enumerate(idxs)}

    la_rank = _rank_map("local_attention")
    rn_rank = _rank_map("residual_norm")

    for name in layer_names:
        flat = layer_flats[name]

        if name.startswith("embed_atom"):
            emb = [v for k, v in flat.items() if k.endswith("embeddings")]
            if emb:
                params["embed_atom"] = {"embedding": emb[0]}
            else:
                params["embed_atom"] = _dense(
                    _get(flat, "kernel"), _get(flat, "bias"))
        elif name in ("extra_embed", "dense_embed", "neighbor_d", "neighbor_w",
                      "after_Lc", "bf_property", "predict_property"):
            params[name] = _dense(_get(flat, "kernel"), _get(flat, "bias"))
        elif re.fullmatch(r"local_attention(_\d+)?", name):
            idx = la_rank[_suffix_num(name, "local_attention")]
            params[f"local_attention_{idx}"] = _local_attention_params(flat, config)
        elif re.fullmatch(r"residual_norm(_\d+)?", name):
            idx = rn_rank[_suffix_num(name, "residual_norm")]
            params[f"residual_norm_{idx}"] = _residual_norm_params(flat)
        elif name.startswith("global_attention"):
            params["global_attention"] = {
                "query": _dense(_get(flat, "query/kernel"), _get(flat, "query/bias")),
                "key": _dense(_get(flat, "key/kernel"), _get(flat, "key/bias")),
            }
        # input layers / lambdas / dropout have no weights and are skipped
    return params


def _get(flat: Dict[str, np.ndarray], suffix: str) -> np.ndarray:
    hits = [v for k, v in flat.items() if k.endswith(suffix)]
    if len(hits) != 1:
        raise KeyError(f"expected exactly one '{suffix}', found {len(hits)}")
    return hits[0]


def _numbered(flat: Dict[str, np.ndarray], base: str):
    """All ``<base>[_k]/...`` sublayers sorted by numeric suffix.

    Returns a list of {var: array} dicts in suffix order.
    """
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in flat.items():
        parts = k.split("/")
        for i, p in enumerate(parts[:-1]):
            if p == base or re.match(rf"{re.escape(base)}_\d+$", p):
                groups.setdefault(p, {})[parts[-1]] = v
    ordered = sorted(groups.items(), key=lambda kv: _suffix_num(kv[0], base))
    return [g for _, g in ordered]


def _local_attention_params(flat, config: ModelConfig) -> dict:
    p = {
        "query": _dense(_get(flat, "query/kernel"), _get(flat, "query/bias")),
        "key": _dense(_get(flat, "key/kernel"), _get(flat, "key/bias")),
        "filter_geo": _dense(_get(flat, "filter_geo/kernel"), _get(flat, "filter_geo/bias")),
    }
    lns = _numbered(flat, "layer_normalization") or _numbered(flat, "layer_norm")
    # creation order (attention.py:111-113): layer_norm first, layer_norm_g second
    p["layer_norm"] = _ln(lns[0]["gamma"], lns[0]["beta"])
    if config.g_update:
        if len(lns) < 2:
            raise ValueError("g_update model but LocalAttention has one LayerNorm")
        p["layer_norm_g"] = _ln(lns[1]["gamma"], lns[1]["beta"])
    return p


def _residual_norm_params(flat) -> dict:
    denses = _numbered(flat, "dense")
    ln = (_numbered(flat, "layer_normalization") or _numbered(flat, "layer_norm"))[0]
    return {
        "dense_1": _dense(denses[0]["kernel"], denses[0]["bias"]),
        "dense_2": _dense(denses[1]["kernel"], denses[1]["bias"]),
        "layer_norm": _ln(ln["gamma"], ln["beta"]),
    }


# --- optimizer state from full-model H5 --------------------------------------

def load_h5_optimizer(path: str, config: ModelConfig):
    """Adam slot variables from a reference full-model H5 checkpoint.

    The reference's ModelCheckpoint saves the WHOLE model (weights +
    optimizer, reference scann_model.py:165-177), so a training run can be
    migrated mid-flight: ``load_h5_params`` restores the weights and this
    restores the Adam state. Returns ``(iterations, mu, nu)`` where mu/nu
    mirror the flax param pytree (same mapping machinery as the weights).

    Keras legacy-Adam H5 layout (verified on tf_keras-generated fixtures):
    ``optimizer_weights/Adam/{m,v}/<trainable variable name>:0`` plus a
    scalar ``iteration(s)``/``iter`` counter. Bias-correction semantics
    line up: after k reference steps ``iterations == k``, and optax's
    ``scale_by_adam`` with ``count == k`` applies t = k+1 on the next step,
    exactly like Keras (and the port's ``Trainer._adam`` at ``step == k``).
    """
    import h5py

    with h5py.File(path, "r") as f:
        if "optimizer_weights" not in f:
            raise ValueError(
                f"{path}: no optimizer_weights group — the H5 was saved "
                "weights-only; train state cannot be migrated (load weights "
                "only via load_h5_params)")
        flat = {k.split(":")[0]: np.asarray(v)
                for k, v in _collect(f["optimizer_weights"]).items()}

    # Two slot layouts exist in the wild: the Keras-2.10-era publisher
    # layout "Adam/m/<var path>" (slot segment SECOND) and the tf_keras
    # legacy-Adam layout "Adam/<var path>/m" (slot segment LAST).
    count = None
    slots = {"m": {}, "v": {}}
    for k, arr in flat.items():
        segs = k.split("/")
        if re.fullmatch(r"iter(ation)?s?", segs[-1]):
            count = int(arr)
            continue
        if segs[-1] in ("m", "v") and len(segs) >= 3:
            slots[segs[-1]]["/".join(segs[1:-1])] = arr
            continue
        for i, s in enumerate(segs[:-1]):
            if s in ("m", "v"):
                slots[s]["/".join(segs[i + 1:])] = arr
                break
        # anything else (e.g. a serialized learning_rate variable) is ignored
    if count is None:
        raise ValueError(f"{path}: optimizer_weights has no iteration counter")
    if not slots["m"] or not slots["v"]:
        raise ValueError(
            f"{path}: optimizer_weights has no m/v slot variables "
            f"(found {sorted(flat)[:5]}...) — unsupported optimizer layout")

    mu = _map_layer_flats(_slot_layer_flats(slots["m"]), config)
    nu = _map_layer_flats(_slot_layer_flats(slots["v"]), config)
    return count, mu, nu


def _slot_layer_flats(slot_paths: dict) -> dict:
    """Group Adam slot-variable paths into the per-layer flats that
    ``_map_layer_flats`` expects.

    Named layers carry their prefix ("local_attention_2/query/kernel");
    ResidualNorm's two inner Dense layers are UNNAMED and appear with bare
    global counters ("dense_7/kernel"). Global Dense counters follow
    creation order — two per ResidualNorm, in residual_norm counter order —
    so the 2i/2i+1-th bare dense (by counter rank) belong to the i-th
    residual_norm (by counter rank).
    """
    named = {}
    bare = {}
    for path, arr in slot_paths.items():
        head, _, rest = path.partition("/")
        if re.fullmatch(r"dense(_\d+)?", head):
            bare.setdefault(head, {})[path] = arr
        else:
            named.setdefault(head, {})[rest or head] = arr

    rn_names = sorted(
        (n for n in named if re.fullmatch(r"residual_norm(_\d+)?", n)),
        key=lambda n: _suffix_num(n, "residual_norm"))
    bare_names = sorted(bare, key=lambda n: _suffix_num(n, "dense"))
    if len(bare_names) != 2 * len(rn_names):
        raise ValueError(
            f"cannot place {len(bare_names)} anonymous Dense slot groups "
            f"onto {len(rn_names)} ResidualNorm layers (expected 2 each)")
    for i, rn in enumerate(rn_names):
        for dname in bare_names[2 * i: 2 * i + 2]:
            named[rn].update(bare[dname])
    return named


# --- weights-only H5 (Keras 3 save_weights: layers/<name>/vars/...) ----------

def _load_weights_only(layers, config: ModelConfig) -> dict:
    params = {}

    def var(g, i):
        return np.asarray(g["vars"][str(i)])

    # anonymous Dense layers follow the reference build order
    # (scann_model.py:361-447)
    dense_roles = []
    if config.feature == "cgcnn":
        dense_roles.append("embed_atom")
    if config.use_ring:
        dense_roles.append("extra_embed")
    dense_roles.append("dense_embed")
    if config.g_update:
        dense_roles += ["neighbor_d", "neighbor_w"]
    dense_roles += ["after_Lc", "bf_property", "predict_property"]

    dense_groups = sorted(
        (k for k in layers.keys() if re.fullmatch(r"dense(_\d+)?", k)),
        key=lambda k: _suffix_num(k, "dense"),
    )
    if len(dense_groups) != len(dense_roles):
        raise ValueError(
            f"expected {len(dense_roles)} anonymous Dense layers "
            f"({dense_roles}), found {len(dense_groups)}"
        )
    for role, gname in zip(dense_roles, dense_groups):
        g = layers[gname]
        params[role] = _dense(var(g, 0), var(g, 1))

    if config.feature == "atomic":
        emb_groups = sorted(
            (k for k in layers.keys()
             if re.fullmatch(r"embedding(_\d+)?", k)),
            key=lambda k: _suffix_num(k, "embedding"))
        if not emb_groups:
            raise ValueError("weights-only H5 has no Embedding group "
                             "(expected for feature='atomic')")
        params["embed_atom"] = {"embedding": var(layers[emb_groups[0]], 0)}

    # Keras name suffixes encode global creation ORDER, not layer position:
    # a model built second in one session names its layers
    # local_attention_7.., residual_norm_7.., embedding_1. Rebase by rank,
    # exactly like the full-model loader does (round-2 VERDICT #6).
    def _rank(base: str) -> Dict[int, int]:
        idxs = sorted(_suffix_num(n, base) for n in layers.keys()
                      if re.fullmatch(base + r"(_\d+)?", n))
        return {i: r for r, i in enumerate(idxs)}

    la_rank = _rank("local_attention")
    rn_rank = _rank("residual_norm")

    for k in layers.keys():
        if re.fullmatch(r"local_attention(_\d+)?", k):
            idx = la_rank[_suffix_num(k, "local_attention")]
            g = layers[k]
            p = {
                "query": _dense(var(g["proj_q"], 0), var(g["proj_q"], 1)),
                "key": _dense(var(g["proj_k"], 0), var(g["proj_k"], 1)),
                "filter_geo": _dense(var(g["filter_geo"], 0), var(g["filter_geo"], 1)),
                "layer_norm": _ln(var(g["layer_norm"], 0), var(g["layer_norm"], 1)),
            }
            if config.g_update:
                p["layer_norm_g"] = _ln(var(g["layer_norm_g"], 0), var(g["layer_norm_g"], 1))
            params[f"local_attention_{idx}"] = p
        elif re.fullmatch(r"residual_norm(_\d+)?", k):
            idx = rn_rank[_suffix_num(k, "residual_norm")]
            g = layers[k]
            seq = g["seq"]["layers"]
            dn = sorted((n for n in seq.keys() if re.fullmatch(r"dense(_\d+)?", n)),
                        key=lambda n: _suffix_num(n, "dense"))
            params[f"residual_norm_{idx}"] = {
                "dense_1": _dense(var(seq[dn[0]], 0), var(seq[dn[0]], 1)),
                "dense_2": _dense(var(seq[dn[1]], 0), var(seq[dn[1]], 1)),
                "layer_norm": _ln(var(g["layer_norm"], 0), var(g["layer_norm"], 1)),
            }
        elif re.fullmatch(r"global_attention(_\d+)?", k):
            g = layers[k]
            params["global_attention"] = {
                "query": _dense(var(g["proj_q"], 0), var(g["proj_q"], 1)),
                "key": _dense(var(g["proj_k"], 0), var(g["proj_k"], 1)),
            }
    return params


# --- export: Flax pytree -> reference-layout H5 weights -----------------------

def save_h5_weights(params: dict, config: ModelConfig, path: str) -> None:
    """Write params (a flax-layout tree: ``compat.params_to_flax`` makes one
    from the port's flat dict) as an H5 file in the reference's
    ``model_weights`` layout (the inverse of ``load_h5_params`` for the
    full-model format), so weights trained here can be inspected/consumed by
    reference-ecosystem tooling.

    Keras layer/variable naming follows the reference graph's creation order
    (``scann_model.py:362-447``, ``attention.py:95-116``): LayerNorms get
    globally-counted ``layer_normalization[_k]`` names, ResidualNorm Denses
    get global ``dense[_k]`` names.
    """
    import h5py

    params = params.get("params", params)
    ln_counter = [0]
    dense_counter = [0]

    def ln_name():
        k = ln_counter[0]
        ln_counter[0] += 1
        return "layer_normalization" + (f"_{k}" if k else "")

    def dense_name():
        k = dense_counter[0]
        dense_counter[0] += 1
        return "dense" + (f"_{k}" if k else "")

    def suffixed(base, i):
        return base + (f"_{i}" if i else "")

    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")

        def put(layer, inner, name, arr):
            mw.create_dataset(f"{layer}/{inner}/{name}:0",
                              data=np.asarray(arr, np.float32))

        def put_dense(layer, inner, p):
            put(layer, inner, "kernel", p["kernel"])
            put(layer, inner, "bias", p["bias"])

        if "embedding" in params["embed_atom"]:
            put("embed_atom", "embed_atom", "embeddings",
                params["embed_atom"]["embedding"])
        else:
            put_dense("embed_atom", "embed_atom", params["embed_atom"])
        if "extra_embed" in params:
            put_dense("extra_embed", "extra_embed", params["extra_embed"])
        put_dense("dense_embed", "dense_embed", params["dense_embed"])
        if config.g_update:
            put_dense("neighbor_d", "neighbor_d", params["neighbor_d"])
            put_dense("neighbor_w", "neighbor_w", params["neighbor_w"])

        # creation order per layer i: LocalAttention (LN, then LN_g) then
        # ResidualNorm (two denses + LN)
        for i in range(config.n_attention):
            la = params[f"local_attention_{i}"]
            lname = suffixed("local_attention", i)
            put_dense(lname, f"{lname}/query", la["query"])
            put_dense(lname, f"{lname}/key", la["key"])
            put_dense(lname, f"{lname}/filter_geo", la["filter_geo"])
            n1 = ln_name()
            put(lname, f"{lname}/{n1}", "gamma", la["layer_norm"]["scale"])
            put(lname, f"{lname}/{n1}", "beta", la["layer_norm"]["bias"])
            if config.g_update:
                n2 = ln_name()
                put(lname, f"{lname}/{n2}", "gamma", la["layer_norm_g"]["scale"])
                put(lname, f"{lname}/{n2}", "beta", la["layer_norm_g"]["bias"])
            if config.use_attn_norm and f"residual_norm_{i}" in params:
                rn = params[f"residual_norm_{i}"]
                rname = suffixed("residual_norm", i)
                put_dense(rname, dense_name(), rn["dense_1"])
                put_dense(rname, dense_name(), rn["dense_2"])
                n3 = ln_name()
                put(rname, f"{rname}/{n3}", "gamma", rn["layer_norm"]["scale"])
                put(rname, f"{rname}/{n3}", "beta", rn["layer_norm"]["bias"])

        put_dense("after_Lc", "after_Lc", params["after_Lc"])
        ga = params["global_attention"]
        put_dense("global_attention", "global_attention/query", ga["query"])
        put_dense("global_attention", "global_attention/key", ga["key"])
        put_dense("bf_property", "bf_property", params["bf_property"])
        put_dense("predict_property", "predict_property", params["predict_property"])
