"""The PyTorch port's notebooks (``notebooks_torch/``), committed executed
by ``tools/make_notebooks_torch.py --device cpu``: clean, free of JAX and
of the JAX package, and predicting what the JAX package's notebook code
predicts.

The committed JAX notebook ``notebooks/qm9_pretrained.ipynb`` was executed
on a TPU (its first output is JAX's notice for the TPU platform), whose
default matmul precision differs from the CPU's: its printed methane and
benzene values are not what the JAX package prints on the CPU. So the
reference here is that notebook's own code cells, run by the JAX package
on the CPU, and the port must print the same digits.
"""

import json
import os
import re

import nbformat
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_DIR = os.path.join(ROOT, "notebooks_torch")
NOTEBOOKS = ["qm9_pretrained.ipynb", "ga_interpretability.ipynb"]
# one printed line of the prediction cell: name, value (4 decimals), GA (3)
LINE = re.compile(r"^(\w+)\s+homo = ([+-]\d+\.\d{4})\s+GA: \[([^\]]*)\]", re.M)


def read(directory, name):
    return nbformat.read(os.path.join(ROOT, directory, name), as_version=4)


def stdout(nb) -> str:
    return "".join(o.get("text", "") for c in nb.cells if c.cell_type == "code"
                   for o in c.get("outputs", []) if o.get("output_type") == "stream")


def predictions(text: str):
    """{name: (value, GA array)} of the printed prediction lines."""
    return {m.group(1): (float(m.group(2)), np.array(m.group(3).split(), float))
            for m in LINE.finditer(text)}


def assert_same_digits(got, want):
    """Equal to the printed digits: one unit of the last one apart at most
    (4 decimals for the value, 3 for each GA score)."""
    assert list(got) == list(want)
    for name in want:
        assert abs(got[name][0] - want[name][0]) <= 1e-4 + 1e-9, name
        assert got[name][1].shape == want[name][1].shape, name
        np.testing.assert_allclose(got[name][1], want[name][1], atol=1e-3 + 1e-9)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_torch_committed_notebook_is_executed_and_clean(name):
    """The checks of ``tests/test_notebooks.py`` on the twin, and a visible
    ``DEVICE`` in the first code cell, "cpu" in the committed copy, with
    the markdown cell that says so."""
    nb = read("notebooks_torch", name)
    code_cells = [c for c in nb.cells if c.cell_type == "code"]
    assert code_cells, "no code cells"
    outputs = [o for c in code_cells for o in c.get("outputs", [])]
    assert outputs, "committed notebook has no executed outputs"
    errors = [o for o in outputs if o.get("output_type") == "error"]
    assert not errors, f"error outputs committed: {errors[0].get('ename')}"
    counts = [c.get("execution_count") for c in code_cells]
    assert all(isinstance(c, int) for c in counts), counts
    assert code_cells[0].source.splitlines()[0] == 'DEVICE = "cpu"'
    assert any('came from `DEVICE = "cpu"`' in c.source for c in nb.cells
               if c.cell_type == "markdown")


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_torch_notebook_imports_no_jax_and_no_scann_tpu(name):
    """No code cell imports JAX or the JAX package; each uses the port."""
    nb = read("notebooks_torch", name)
    bad = []
    for c in nb.cells:
        if c.cell_type != "code":
            continue
        for line in c.source.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                for mod in " ".join(words[1:]).split(" import ")[0].split(","):
                    root = mod.strip().split(".")[0].split()[0]
                    if root in ("jax", "jaxlib", "flax", "optax", "orbax", "scann_tpu"):
                        bad.append(line)
    assert bad == []
    assert "scann_tpu_torch" in "".join(c.source for c in nb.cells)


@pytest.fixture(scope="module")
def jax_notebook_on_cpu():
    """The printed predictions of ``notebooks/qm9_pretrained.ipynb``'s code
    cells run by the JAX package on the CPU, in that notebook's directory
    (the plot cell, which writes a PNG there, is left out)."""
    import contextlib
    import io

    nb = read("notebooks", "qm9_pretrained.ipynb")
    out, cwd, ns = io.StringIO(), os.getcwd(), {}
    os.chdir(os.path.join(ROOT, "notebooks"))
    try:
        with contextlib.redirect_stdout(out):
            for c in nb.cells:
                if c.cell_type == "code" and "savefig" not in c.source:
                    exec(compile(c.source, "<jax notebook>", "exec"), ns)
    finally:
        os.chdir(cwd)
    return predictions(out.getvalue())


def test_torch_qm9_pretrained_predictions_equal_the_jax_notebook(jax_notebook_on_cpu):
    """The committed twin's printed predictions and GA scores equal the
    JAX notebook's code on the CPU to the printed digits."""
    got = predictions(stdout(read("notebooks_torch", "qm9_pretrained.ipynb")))
    assert list(got) == ["water", "methane", "benzene"]
    assert_same_digits(got, jax_notebook_on_cpu)


def test_torch_qm9_pretrained_reexecutes(tmp_path, jax_notebook_on_cpu):
    """The pretrained twin re-runs end to end here (nbclient, ``DEVICE =
    "cpu"`` as committed) in a scratch copy of its directory, so the PNG it
    writes lands there, and prints what the committed copy printed and the
    JAX notebook's code prints."""
    from nbclient import NotebookClient

    for sub in ("scann_tpu_torch", "tests", "build"):
        os.makedirs(os.path.join(ROOT, sub), exist_ok=True)
        os.symlink(os.path.join(ROOT, sub), tmp_path / sub)
    run_dir = tmp_path / "notebooks_torch"
    run_dir.mkdir()
    nb = read("notebooks_torch", "qm9_pretrained.ipynb")
    committed = predictions(stdout(nb))
    client = NotebookClient(nb, timeout=600, kernel_name="python3",
                            resources={"metadata": {"path": str(run_dir)}})
    client.execute()  # raises CellExecutionError on any failure
    got = predictions(stdout(nb))
    assert (run_dir / "qm9_pretrained_ga.png").exists()
    assert_same_digits(got, committed)
    assert_same_digits(got, jax_notebook_on_cpu)
