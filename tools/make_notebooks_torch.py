"""Generate the PyTorch port's two notebooks (the twins of
``tools/make_notebooks.py``'s, programmatically, so they stay in sync with
the port's API) and execute them with nbclient.

- ``notebooks_torch/qm9_pretrained.ipynb``: load a Keras H5 SCANN+
  checkpoint into the port, predict + per-atom GA scores for example
  molecules, visualize (twin of ``notebooks/qm9_pretrained.ipynb``),
- ``notebooks_torch/ga_interpretability.ipynb``: train briefly on a
  synthetic dataset, then the dataset-level GA-ratio interpretability
  analysis (twin of ``notebooks/ga_interpretability.ipynb``).

Run: python tools/make_notebooks_torch.py [--device cuda|cpu] [--no-execute]

The first code cell of each notebook sets ``DEVICE`` ("cuda" by default:
the GPU, where a missing GPU raises; "cpu": the CPU). ``--device`` writes
its value there before the notebook executes, and a markdown cell records
which device the saved outputs came from. The committed notebooks were
executed with ``--device cpu``. Executing them needs nbclient with a
Jupyter kernel named python3, and h5py (the H5 checkpoint).
"""

import argparse
import os

import nbformat as nbf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_LINE = 'DEVICE = "cuda"'


def _nb(cells, device: str):
    """A notebook of (kind, source) cells, its ``DEVICE`` set to ``device``."""
    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {"name": "python3", "language": "python",
                                 "display_name": "Python 3"}
    out = []
    for kind, src in cells:
        if kind == "device":
            kind, src = "md", device_note(device)
        elif DEVICE_LINE in src:
            src = src.replace(DEVICE_LINE, f'DEVICE = "{device}"')
        out.append(nbf.v4.new_markdown_cell(src) if kind == "md"
                   else nbf.v4.new_code_cell(src))
    nb.cells = out
    return nb


def device_note(device: str) -> str:
    where = ("the CPU: the eager model and the kernels' plain versions" if device == "cpu"
             else "the GPU: the port's CUDA kernels")
    return f"""`DEVICE` below picks where the model runs: `"cuda"` (the GPU, with the
port's CUDA kernels) or `"cpu"` (the CPU). Nothing falls back: `"cuda"`
without a GPU raises. `python tools/make_notebooks_torch.py --device ...`
writes the value before it executes the notebook. The saved outputs of
this copy came from `DEVICE = "{device}"`, that is from {where}."""


PRETRAINED = [
    ("md", """# SCANN⁺ inference from a Keras H5 checkpoint (PyTorch port)

The PyTorch port's twin of `notebooks/qm9_pretrained.ipynb` (itself the
counterpart of the reference `notebooks/qm9_pretrained.ipynb`): load a
published (Keras H5) SCANN checkpoint, predict a property and the per-atom
**GA scores** (the interpretability signal: GlobalAttention's per-atom
weights) for example molecules, and visualize them.

The H5 is converted to the port's parameters on the fly
(`scann_tpu_torch.compat.h5_loader.load_h5_params`, which needs h5py): no
TensorFlow needed. Here we use the flagship-architecture golden fixture
checkpoint shipped with the test suite; the port's predictions on it match
the reference implementation to numerical tolerance
(`tests/test_torch_golden.py`)."""),
    ("device", ""),
    ("code", """DEVICE = "cuda"
import json, os, sys
sys.path.insert(0, os.path.abspath(".."))  # repo root
import numpy as np

from scann_tpu_torch.api import Scann

CONFIG = "../tests/fixtures/scann_plus_qm9full.json"
H5 = "../tests/fixtures/scann_plus_qm9full.h5"

config = json.load(open(CONFIG))
scann = Scann(config, pretrained=H5, device=DEVICE)
print("model:", {k: config["model"][k]
                 for k in ("n_attention", "local_dim", "num_head", "g_update")})
print("target:", config["hyper"]["target"])"""),
    ("md", """## Example molecules

Standard gas-phase geometries (Å), written as xyz files, exactly what
`scann_tpu_torch.cli.predict_files` / OVITO workflows consume. Any
xyz/CIF/POSCAR/mol file works via `Structure.from_file`."""),
    ("code", '''MOLECULES = {
    "water": """3
water
O 0.0000 0.0000 0.1173
H 0.0000 0.7572 -0.4692
H 0.0000 -0.7572 -0.4692
""",
    "methane": """5
methane
C 0.0000 0.0000 0.0000
H 0.6291 0.6291 0.6291
H -0.6291 -0.6291 0.6291
H -0.6291 0.6291 -0.6291
H 0.6291 -0.6291 -0.6291
""",
    "benzene": """12
benzene
C 1.3960 0.0000 0.0000
C 0.6980 1.2090 0.0000
C -0.6980 1.2090 0.0000
C -1.3960 0.0000 0.0000
C -0.6980 -1.2090 0.0000
C 0.6980 -1.2090 0.0000
H 2.4800 0.0000 0.0000
H 1.2400 2.1480 0.0000
H -1.2400 2.1480 0.0000
H -2.4800 0.0000 0.0000
H -1.2400 -2.1480 0.0000
H 1.2400 -2.1480 0.0000
""",
}
import tempfile
tmp = tempfile.mkdtemp("nb_mols")
paths = {}
for name, text in MOLECULES.items():
    p = os.path.join(tmp, name + ".xyz")
    open(p, "w").write(text)
    paths[name] = p
list(paths)'''),
    ("md", """## Predict + GA scores

`predict_structure` featurizes (Voronoi tessellation on the host: the
C++ cell clipper when available), pads, and runs the forward (on the GPU
the whole-model molecule kernel); it returns the un-standardized
prediction and the `[n_atoms]` GA scores."""),
    ("code", """from scann_tpu_torch.data.structure import Structure

results = {}
for name, p in paths.items():
    struct = Structure.from_file(p)
    value, ga = scann.predict_structure(struct)
    results[name] = (struct, value, ga)
    print(f"{name:8s} {config['hyper']['target']} = {value:+.4f}   "
          f"GA: {np.array2string(ga, precision=3)}")"""),
    ("md", """GA scores sum to 1 over the atoms of each structure; a score above
`1/n_atoms` means the readout attends to that atom more than uniformly.
For benzene the six carbons should dominate the twelve hydrogens:"""),
    ("code", """import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, len(results), figsize=(4 * len(results), 3))
for ax, (name, (struct, value, ga)) in zip(np.atleast_1d(axes), results.items()):
    colors = ["tab:gray" if s == "H" else "tab:blue" for s in struct.species]
    ax.bar(range(len(ga)), ga, color=colors)
    ax.axhline(1 / len(ga), ls="--", c="k", lw=0.8, label="uniform")
    ax.set_title(f"{name}: {value:+.3f}")
    ax.set_xticks(range(len(ga)))
    ax.set_xticklabels(struct.species, fontsize=7)
    ax.legend(fontsize=7)
fig.tight_layout()
fig.savefig("qm9_pretrained_ga.png", dpi=80)
print("saved qm9_pretrained_ga.png")"""),
    ("md", """## OVITO export

`python -m scann_tpu_torch.cli.predict_files RUN_DIR OUT_DIR mol.xyz` writes
the GA score as a 5th xyz column for color-coding atoms in OVITO, the
reference's visualization workflow (`predict_files.py:47-59`)."""),
]


GA_ANALYSIS = [
    ("md", """# Dataset-level GA-score interpretability (PyTorch port)

The PyTorch port's twin of `notebooks/ga_interpretability.ipynb` (the
counterpart of the reference `notebooks/sm_pretrained.ipynb` SmFe12
workflow): run a trained model over a dataset and analyze **which chemical
environments the model attends to**: per-element GA-score ratios, and
their correlation with the target (the npj Comput. Mater. paper's
interpretability result: attention concentrates on dopant sites in
low-formation-energy structures).

Everything here runs offline on a synthetic dataset (no downloads); with a
real preprocessed dataset the identical code produces the paper-style
analysis, or use `examples_torch/ga_analysis.py` as a CLI."""),
    ("device", ""),
    ("code", """DEVICE = "cuda"
import os, sys, tempfile
sys.path.insert(0, os.path.abspath(".."))
import numpy as np

from scann_tpu_torch.data.synthetic import make_synthetic_dataset

DATA = tempfile.mkdtemp(prefix="nb_ga_data_")
e_path, n_path = make_synthetic_dataset(DATA, n_structures=300,
                                        min_atoms=6, max_atoms=14, seed=5)
print(os.path.basename(e_path))"""),
    ("md", """## Train a small model

A compact SCANN⁺ (2 layers, dim 32) converges enough in a few epochs to
show structure in the GA scores. On the GPU each step launches the
molecule backward kernel and each evaluation the forward kernel; on the
CPU the same steps run their plain versions."""),
    ("code", """from scann_tpu_torch.api import Scann
from scann_tpu_torch.config import ScannConfig

cfg = ScannConfig.from_dict({
    "model": {"n_atoms": 12, "embedding_dim": 16, "n_attention": 2,
              "local_dim": 32, "num_head": 4, "global_dim": 32,
              "dense_out": 16, "g_update": True, "use_ga_norm": True},
    "hyper": {"batch_size": 32, "epochs": 8, "patience": 50,
              "train_size": 240, "test_size": 30, "lr": 1e-3,
              "min_lr": 1e-4, "scheduler": "cosine", "scaler": True,
              "save_path": os.path.join(tempfile.mkdtemp(prefix="nb_ga_run_"), "run"),
              "target": "homo",
              "data_energy_path": e_path, "data_nei_path": n_path},
})
scann = Scann(cfg, device=DEVICE)
scann.prepare_dataset()
report = scann.train()
print("val MAE trajectory:", [round(v, 3) for v in report["val_mae"]])"""),
    ("md", "## Predict with GA scores over the whole dataset"),
    ("code", """preds, gas = scann.predict_data(with_ga=True)
print(len(preds), "structures; first prediction:", round(float(preds[0]), 4))"""),
    ("md", """## Per-element attention ratios

Normalize each structure's GA scores by `n_atoms` so 1.0 = uniform
attention, then aggregate by element."""),
    ("code", """import collections

from scann_tpu_torch.data.atomic_data import chemical_symbols
from scann_tpu_torch.data.pipeline import load_dataset

records, _ = load_dataset(e_path, n_path, "homo")
elem_ratios = collections.defaultdict(list)
struct_rows = []
for rec, pred, ga in zip(records, preds, gas):
    n = len(rec["atomic"])
    ratios = np.asarray(ga) * n
    for z, r in zip(rec["atomic"], ratios):
        elem_ratios[chemical_symbols[int(z)]].append(float(r))
    struct_rows.append((pred, rec["target"], ratios, rec["atomic"]))

for el, rs in sorted(elem_ratios.items()):
    print(f"{el:3s} mean GA ratio {np.mean(rs):.3f} +- {np.std(rs):.3f} "
          f"(n={len(rs)})")"""),
    ("md", """## GA-ratio vs target correlation

The paper's signal: does attention on an element track the target? (On
synthetic data the correlation is whatever the generator induced; with
real SmFe12 data this reproduces the dopant-site analysis.)"""),
    ("code", """import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

elements = sorted(elem_ratios, key=lambda e: -len(elem_ratios[e]))[:4]
fig, axes = plt.subplots(1, len(elements), figsize=(3.2 * len(elements), 3))
for ax, el in zip(np.atleast_1d(axes), elements):
    xs, ys = [], []
    for pred, target, ratios, zs in struct_rows:
        sel = [chemical_symbols[int(z)] == el for z in zs]
        if any(sel):
            xs.append(float(np.mean(ratios[np.asarray(sel)])))
            ys.append(float(target))
    corr = np.corrcoef(xs, ys)[0, 1] if len(xs) > 2 else float("nan")
    ax.scatter(xs, ys, s=8, alpha=0.6)
    ax.set_title(f"{el}: r = {corr:.2f}")
    ax.set_xlabel("mean GA ratio")
    ax.set_ylabel("target")
fig.tight_layout()
fig.savefig("ga_ratio_vs_target.png", dpi=80)
print("saved ga_ratio_vs_target.png")"""),
]

NOTEBOOKS = {"qm9_pretrained.ipynb": PRETRAINED,
             "ga_interpretability.ipynb": GA_ANALYSIS}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--no-execute", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the DEVICE the notebooks run on (default cuda; cpu: the CPU)")
    args = p.parse_args(argv)

    out_dir = os.path.join(ROOT, "notebooks_torch")
    os.makedirs(out_dir, exist_ok=True)
    for name, cells in NOTEBOOKS.items():
        nb = _nb(cells, args.device)
        path = os.path.join(out_dir, name)
        if not args.no_execute:
            from nbclient import NotebookClient

            print(f"executing {name} on {args.device} ...", flush=True)
            client = NotebookClient(nb, timeout=1200, kernel_name="python3",
                                    resources={"metadata": {"path": out_dir}})
            client.execute()
        nbf.write(nb, path)
        print("wrote", path)


if __name__ == "__main__":
    main()
