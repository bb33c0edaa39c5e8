"""The kernel build cache of the PyTorch port (``kernels/_build.py``,
``utils/exec_cache.py``) on the CPU, with no nvcc: the key covers the
toolchain, a corrupt library is removed, rebuilt once and counted (a stub
stands in for nvcc), builders sharing a directory build each library once,
directories are private, and ``Scann.enable_exec_cache``,
``BatchedPredictor(exec_cache=...)``, ``cli.train --exec-cache`` and
``cli.serve --exec-cache`` point the cache where the JAX package's
counterparts point theirs."""

import _ctypes
import os
import stat
import subprocess
import sys
import threading

import pytest
import torch

from scann_tpu_torch.api import Scann
from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, save_config
from scann_tpu_torch.kernels import _build
from scann_tpu_torch.utils import exec_cache
from scann_tpu_torch.utils.exec_cache import ExecutableCache

torch.set_num_threads(1)

SMALL = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
             global_dim=32, dense_out=16)
PTXAS = ("ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'\n"
         "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
         "ptxas info    : Used 96 registers\n")


@pytest.fixture(autouse=True)
def _own_build_cache(monkeypatch):
    """Every test leaves the process's build cache as it found it."""
    monkeypatch.setattr(_build, "_cache", _build._cache)
    monkeypatch.setattr(_build, "build_logs", dict(_build.build_logs))


def _stub_nvcc(monkeypatch, library, seconds=0.0):
    """``_build._start`` without nvcc: a child process waits ``seconds``,
    copies ``library`` to the temporary output and prints a ptxas report.
    Returns the list of names it was started for."""
    started = []

    def start(name, out):
        started.append(name)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.stub.tmp"
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import shutil, sys, time; time.sleep(float(sys.argv[4])); "
             "shutil.copy(sys.argv[1], sys.argv[2]); "
             "sys.stdout.write(sys.argv[3])", library, tmp, PTXAS, str(seconds)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        proc.scann_tmp = tmp
        return proc

    monkeypatch.setattr(_build, "_start", start)
    return started


def test_torch_build_key_covers_flags_nvcc_and_host_compiler(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, release 12.8")
    monkeypatch.setattr(_build, "host_compiler_version", lambda: "g++ (GCC) 13.2.0")
    base = _build.library_path("scann_forward", "/cache")
    assert base.startswith("/cache/libscann_forward_") and base.endswith(".so")
    assert _build.library_path("scann_forward", "/cache") == base
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, release 12.9")
    other_nvcc = _build.library_path("scann_forward", "/cache")
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, release 12.8")
    monkeypatch.setattr(_build, "host_compiler_version", lambda: "g++ (GCC) 14.1.0")
    other_host = _build.library_path("scann_forward", "/cache")
    monkeypatch.setattr(_build, "host_compiler_version", lambda: "g++ (GCC) 13.2.0")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-2])
    other_flags = _build.library_path("scann_forward", "/cache")
    assert len({base, other_nvcc, other_host, other_flags}) == 4


def test_torch_tool_versions_are_read_once_a_process(monkeypatch):
    runs = []
    real = subprocess.run
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: runs.append(cmd) or real(cmd, **kw))
    tool = sys.executable        # a program that answers --version
    _build.tool_version.cache_clear()
    first = _build.tool_version(tool)
    assert "Python" in first and _build.tool_version(tool) == first
    assert runs == [[tool, "--version"]]
    assert _build.tool_version("/nonexistent/nvcc") == "/nonexistent/nvcc: not found"
    _build.tool_version.cache_clear()


def test_torch_cache_dir_is_private_and_the_default_falls_back(tmp_path, monkeypatch):
    cache = ExecutableCache(str(tmp_path / "a" / "b"))
    assert cache.cache_dir == str(tmp_path / "a" / "b")
    assert stat.S_IMODE(os.stat(cache.cache_dir).st_mode) == 0o700
    assert cache.stats == {"mem_hits": 0, "disk_hits": 0, "compiles": 0, "load_errors": 0,
                           "save_errors": 0, "invalidated": 0}
    # beside the package where it can be written, else the per-user cache
    (tmp_path / "file").write_text("")
    monkeypatch.setattr(_build, "DEFAULT_BUILD_DIR", str(tmp_path / "file" / "build"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert _build.default_build_dir() == str(tmp_path / "xdg" / "scann_tpu_torch" / "build")
    monkeypatch.setattr(_build, "DEFAULT_BUILD_DIR", str(tmp_path / "repo" / "build"))
    assert _build.default_build_dir() == str(tmp_path / "repo" / "build")


def test_torch_corrupt_library_is_removed_rebuilt_once_and_counted(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_version", lambda: "stub nvcc")
    started = _stub_nvcc(monkeypatch, _ctypes.__file__)
    cache = _build.set_build_dir(str(tmp_path / "cache"))
    path = cache.path("scann_forward")
    with open(path, "wb") as f:
        f.write(b"not a shared object")
    lib = cache.get_or_compile("scann_forward")
    assert lib is _build.load_library("scann_forward")
    assert started == ["scann_forward"]
    assert cache.stats["load_errors"] == 1 and cache.stats["compiles"] == 1
    assert cache.stats["mem_hits"] == 1 and cache.stats["disk_hits"] == 0
    assert open(path, "rb").read() == open(_ctypes.__file__, "rb").read()
    # the build log is kept beside the library, so a later process reads it
    assert open(path + ".log").read() == PTXAS
    _build.build_logs.clear()
    assert _build.kernel_resources("scann_forward") == [("_Z6kernelv", 96, 8, 4)]
    assert not [f for f in os.listdir(cache.cache_dir) if f.endswith(".tmp")]

    # a second process with the same directory loads it without a build
    fresh = ExecutableCache(cache.cache_dir)
    fresh.get_or_compile("scann_forward")
    assert fresh.stats["disk_hits"] == 1 and fresh.stats["compiles"] == 0
    assert fresh.build(["scann_forward"]) == {"scann_forward": path}
    assert fresh.stats["compiles"] == 0 and started == ["scann_forward"]

    # a rebuild that fails to load too raises: nothing falls back
    bad = tmp_path / "bad.so"
    bad.write_bytes(b"still not a shared object")
    _stub_nvcc(monkeypatch, str(bad))
    other = ExecutableCache(str(tmp_path / "other"))
    with open(other.path("scann_loop"), "wb") as f:
        f.write(b"corrupt")
    with pytest.raises(OSError):
        other.get_or_compile("scann_loop")
    assert other.stats["load_errors"] == 1 and other.stats["compiles"] == 1

    other.invalidate("scann_loop")
    assert other.stats["invalidated"] == 1 and not os.path.exists(other.path("scann_loop"))


def test_torch_builders_sharing_a_directory_build_each_library_once(tmp_path, monkeypatch):
    """Two builders on one empty directory at once, as the ranks of a job on
    one host start: the first builds each library, the other waits on the
    directory's lock and loads what the first published."""
    monkeypatch.setattr(_build, "nvcc_version", lambda: "stub nvcc")
    started = _stub_nvcc(monkeypatch, _ctypes.__file__, seconds=0.5)
    caches = [ExecutableCache(str(tmp_path / "cache")) for _ in range(2)]
    names = ["scann_forward", "scann_loop"]
    together, errors = threading.Barrier(2), []

    def rank(cache):
        together.wait()
        try:
            cache.build(names)
        except Exception as e:        # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(c,)) for c in caches]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(started) == names
    assert sorted(c.stats["compiles"] for c in caches) == [0, 2]
    for c in caches:
        for n in names:
            c.get_or_compile(n)
        assert c.stats["disk_hits"] == 2 and c.stats["load_errors"] == 0
    assert sorted(started) == names
    assert not [f for f in os.listdir(caches[0].cache_dir) if f.endswith(".tmp")]


def test_torch_failed_build_raises_and_counts(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_version", lambda: "stub nvcc")
    _stub_nvcc(monkeypatch, str(tmp_path / "missing.so"))     # the copy fails
    cache = ExecutableCache(str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="nvcc failed for scann_backward.cu"):
        cache.build(["scann_backward"])
    assert cache.stats["save_errors"] == 1 and cache.stats["compiles"] == 0
    assert os.listdir(cache.cache_dir) == []


def test_torch_env_fingerprint_names_torch_and_the_toolchain(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_version", lambda: "release 12.8, V12.8.93\n")
    import json

    fp = json.loads(exec_cache.env_fingerprint())
    assert fp["torch"] == torch.__version__ and fp["nvcc"] == "release 12.8, V12.8.93"
    assert set(fp) == {"torch", "cuda_runtime", "device", "capability", "nvcc"}


def _config(tmp_path):
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset

    energy, nbr = make_synthetic_dataset(str(tmp_path / "data"), n_structures=20, min_atoms=3,
                                         max_atoms=8, seed=2)
    return ScannConfig(model=ModelConfig(**SMALL),
                       hyper=HyperConfig(batch_size=8, data_energy_path=energy,
                                         data_nei_path=nbr, save_path=str(tmp_path / "run"),
                                         epochs=1, seed=0, target="homo"))


def test_torch_enable_exec_cache_defaults_to_the_workdir_and_warns_when_uncreatable(tmp_path):
    scann = Scann(_config(tmp_path), device="cpu")
    want = os.path.join(scann.trainer.workdir, "exec_cache")
    assert scann.enable_exec_cache() == os.path.abspath(want)
    assert _build.build_dir() == os.path.abspath(want) == scann.exec_cache.cache_dir
    assert stat.S_IMODE(os.stat(want).st_mode) == 0o700
    assert scann.enable_exec_cache(str(tmp_path / "elsewhere")) == str(tmp_path / "elsewhere")
    (tmp_path / "a_file").write_text("")
    with pytest.warns(UserWarning, match="exec cache disabled"):
        assert scann.enable_exec_cache(str(tmp_path / "a_file" / "cache")) is None
    assert _build.build_dir() == str(tmp_path / "elsewhere")


def test_torch_trainer_reads_the_configured_exec_cache_dir(tmp_path):
    cfg = _config(tmp_path)
    cfg.tpu.exec_cache_dir = str(tmp_path / "configured")
    scann = Scann(cfg, device="cpu")
    assert scann.exec_cache is scann.trainer.exec_cache is _build.cache()
    assert _build.build_dir() == str(tmp_path / "configured")


def test_torch_batched_predictor_enables_the_exec_cache_before_warmup(tmp_path):
    from scann_tpu_torch.serve import BatchedPredictor

    scann = Scann(_config(tmp_path), device="cpu")
    scann.init_params(0)
    seen = []
    warmup = scann.warmup_serving
    scann.warmup_serving = lambda shapes: seen.append(_build.build_dir()) or warmup(shapes)
    p = BatchedPredictor(scann, exec_cache=str(tmp_path / "serve_cache"), warmup_shapes=[(8, 8)])
    try:
        assert seen == [str(tmp_path / "serve_cache")] and p.warmed == [(8, 8)]
    finally:
        p.close()
    p = BatchedPredictor(scann, exec_cache="auto", warmup_shapes=[])
    p.close()
    assert _build.build_dir() == os.path.abspath(os.path.join(scann.trainer.workdir,
                                                              "exec_cache"))


class _Stop(Exception):
    pass


def test_torch_train_cli_exec_cache_flag(tmp_path, monkeypatch):
    from scann_tpu_torch import api
    from scann_tpu_torch.cli import train

    cfg = _config(tmp_path)
    path = tmp_path / "c.yaml"
    save_config(cfg, str(path))
    # the run itself, with a directory named: the kernels' cache is there
    train.main(["homo", str(path), "--epochs", "1", "--device", "cpu",
                "--exec-cache", str(tmp_path / "named")])
    assert _build.build_dir() == str(tmp_path / "named")
    assert stat.S_IMODE(os.stat(tmp_path / "named").st_mode) == 0o700
    # the bare flag: {save_path}/exec_cache, as the JAX CLI has it
    seen = []

    def capture(config, **kw):
        seen.append(config.tpu.exec_cache_dir)
        raise _Stop

    monkeypatch.setattr(api, "Scann", capture)
    with pytest.raises(_Stop):
        train.main(["homo", str(path), "--device", "cpu", "--exec-cache"])
    with pytest.raises(_Stop):
        train.main(["homo", str(path), "--device", "cpu"])
    assert seen == [os.path.join(cfg.hyper.save_path, "exec_cache"), None]


def test_torch_serve_cli_exec_cache_flag(tmp_path, monkeypatch):
    from scann_tpu_torch import serve
    from scann_tpu_torch.cli import serve as cli_serve

    seen = []

    def capture(model_dir, **kw):
        seen.append(kw["exec_cache"])
        raise _Stop

    monkeypatch.setattr(serve.BatchedPredictor, "from_model_dir", staticmethod(capture))
    for extra, want in (([], None), (["--exec-cache"], "auto"),
                        (["--exec-cache", str(tmp_path)], str(tmp_path))):
        with pytest.raises(_Stop):
            cli_serve.main([str(tmp_path / "run"), "--device", "cpu"] + extra)
        assert seen[-1] == want
