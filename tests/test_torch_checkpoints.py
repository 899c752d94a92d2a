"""The port's checkpoint readers (`utils/checkpoints.py`, `utils/native_io.py`
over its own `native/tensor_io.cpp`) and `utils/pil_image.py` against the
JAX package's, on the CPU: the same files read by both give the same keys
and values, exactly.

Every file lives under pytest's `tmp_path`; the cache directories are
monkeypatched there, and the JAX package's native library (which it builds
under `~/.cache`) is pointed into `tmp_path` too. The port builds its own
into the repository's git-ignored `build/`.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from perceptor_tpu.utils import checkpoints as jcheckpoints
from perceptor_tpu.utils import native_io as jnative_io
from perceptor_tpu.utils.pil_image import pil_image as jpil_image
from perceptor_tpu_torch.utils import checkpoints, native_io, pil_image

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native reader, built into tmp_path."""
    monkeypatch.setattr(jnative_io, "_LIBRARY", str(tmp_path / "jax_lib" / "libtensor_io.so"))
    monkeypatch.setattr(jnative_io, "_lib", None)
    monkeypatch.setattr(jnative_io, "_build_failed", False)
    return jnative_io


def _assert_same(got: dict, want: dict):
    """The port's {name: tensor or array} equals JAX's {name: array}:
    keys, dtypes and values."""
    assert sorted(got) == sorted(want)
    for key in want:
        value = got[key]
        value = value.numpy() if isinstance(value, torch.Tensor) else value
        assert value.dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_find_checkpoint_searches_like_jax(tmp_path, monkeypatch):
    """Directory order, suffix order (.safetensors first), a name with its
    own suffix, a path as it stands, empty names skipped, None when
    nothing exists: the port finds what JAX finds."""
    dirs = [tmp_path / d for d in ("first", "second", "third")]
    for d in dirs:
        d.mkdir()
    (dirs[1] / "net.npz").write_bytes(b"")
    (dirs[2] / "net.safetensors").write_bytes(b"")
    (dirs[2] / "other.pt").write_bytes(b"")
    (dirs[0] / "named.bin").write_bytes(b"")
    (dirs[2] / "both.npz").write_bytes(b"")
    (dirs[2] / "both.safetensors").write_bytes(b"")
    for module in (checkpoints, jcheckpoints):
        monkeypatch.setattr(module, "CACHE_DIRS", ("", *(str(d) for d in dirs)))
    queries = [("net",), ("other",), ("named.bin",), ("both",), ("missing",), ("", "other"),
               ("missing", "net"), (str(dirs[2] / "other.pt"),), ("named",)]
    found = [checkpoints.find_checkpoint(*q) for q in queries]
    assert found == [jcheckpoints.find_checkpoint(*q) for q in queries]
    assert found[:5] == [str(dirs[1] / "net.npz"), str(dirs[2] / "other.pt"),
                         str(dirs[0] / "named.bin"), str(dirs[2] / "both.safetensors"), None]
    assert checkpoints._SUFFIXES == jcheckpoints._SUFFIXES


def test_cache_dirs_follow_the_environment_like_jax(tmp_path):
    """A fresh process with PERCEPTOR_TPU_CACHE and HOME set: both packages
    list the same directories and find a file under the variable's."""
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "weights.npz").write_bytes(b"")
    code = (
        "from perceptor_tpu.utils import checkpoints as j\n"
        "from perceptor_tpu_torch.utils import checkpoints as p\n"
        "assert p.CACHE_DIRS == j.CACHE_DIRS, (p.CACHE_DIRS, j.CACHE_DIRS)\n"
        "import json\n"
        "print(json.dumps([p.CACHE_DIRS, p.find_checkpoint('weights'), j.find_checkpoint('weights')]))\n"
    )
    env = {**os.environ, "PERCEPTOR_TPU_CACHE": str(cache), "HOME": str(tmp_path / "home"),
           "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    home_cache = str(tmp_path / "home" / ".cache" / "perceptor_tpu")
    path = str(cache / "weights.npz")
    assert json.loads(proc.stdout.splitlines()[-1]) == [["models", home_cache, str(cache)], path,
                                                         path]


class _Snapshot(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 2)
        self.register_buffer("steps", torch.arange(4))


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "conv.weight": torch.randn(4, 3, 3, 3, generator=g),
        "norm.bias": torch.randn(4, generator=g).to(torch.float16),
        "embed.weight": torch.randn(5, 6, generator=g).to(torch.bfloat16),
        "counts": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "scalar": torch.tensor(2.5),
    }


def _write(path: Path, fmt: str) -> None:
    tensors = _tensors()
    if fmt == "npz":
        np.savez(path, **{k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
                          for k, v in tensors.items()})
    elif fmt == "pt":
        torch.save(tensors, path)
    elif fmt == "pt_state_dict":
        torch.save({"state_dict": tensors, "epoch": 3}, path)
    elif fmt == "pt_model":
        torch.save({"model": tensors}, path)
    elif fmt == "pkl_module":
        snapshot = _Snapshot()
        with open(path, "wb") as f:
            pickle.dump({"D": torch.nn.Linear(2, 2), "G_ema": snapshot, "G": None}, f)
    elif fmt == "pkl_dict":
        with open(path, "wb") as f:
            pickle.dump({"generator": tensors}, f)
    elif fmt == "safetensors":
        save_file({k: v.contiguous() for k, v in tensors.items()}, str(path),
                  metadata={"format": "pt"})


FORMATS = {"npz": ".npz", "pt": ".pt", "pt_state_dict": ".ckpt", "pt_model": ".pth",
           "pkl_module": ".pkl", "pkl_dict": ".pkl", "safetensors": ".safetensors"}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_load_state_dict_matches_jax(fmt, tmp_path, jax_native):
    """The same file through both packages' `load_state_dict`: equal keys,
    dtypes and values (torch pickles widened to fp32, safetensors' BF16
    widened exactly, F16 and I64 kept), the port's values CPU tensors."""
    path = tmp_path / f"weights{FORMATS[fmt]}"
    _write(path, fmt)
    got = checkpoints.load_state_dict(str(path))
    want = jcheckpoints.load_state_dict(str(path))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in got.values())
    _assert_same(got, want)
    if fmt == "safetensors":
        assert jax_native.native_available() and native_io.native_available()
        assert got["embed.weight"].dtype == torch.float32
        assert torch.equal(got["embed.weight"], _tensors()["embed.weight"].float())
        assert got["norm.bias"].dtype == torch.float16 and got["counts"].dtype == torch.int64


def test_a_pickle_without_a_state_dict_is_refused(tmp_path):
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump([1, 2], f)
    with pytest.raises(ValueError, match="expected a module"):
        checkpoints.load_state_dict(str(path))


def test_native_read_span_matches_python(tmp_path, jax_native):
    """The native reader (built with g++ here) against the Python read and
    JAX's native reader, at unaligned offsets, across a page, and over 8 MB
    (the multithreaded copy)."""
    assert native_io.native_available() and native_io.build_error() is None
    assert native_io.library_path().parent == REPO / "build"
    data = np.random.default_rng(0).integers(0, 256, size=(9 << 20) + 77, dtype=np.uint8)
    path = tmp_path / "blob.bin"
    data.tofile(path)
    for offset, nbytes in ((0, 16), (13, 4099), (4095, 3), (5, (8 << 20) + 50), (77, 9 << 20)):
        native = native_io.read_span(str(path), offset, nbytes)
        np.testing.assert_array_equal(native, data[offset:offset + nbytes])
        np.testing.assert_array_equal(native_io.read_span_python(str(path), offset, nbytes),
                                      native)
        np.testing.assert_array_equal(jax_native.read_span(str(path), offset, nbytes), native)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_params_and_native_params_across_packages(direction, tmp_path):
    """A params-v1 artifact written by one package reads back through the
    other's `load_state_dict` + `native_params` as the same tree."""
    rng = np.random.default_rng(1)
    tree = {"dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                      "bias": np.zeros(4, np.float32)},
            "steps": np.arange(3, dtype=np.int32)}
    path = str(tmp_path / "params")
    writer, reader = ((jcheckpoints, checkpoints) if direction == "jax_to_port"
                      else (checkpoints, jcheckpoints))
    if writer is checkpoints:
        writer.save_params(path, {"dense": {k: torch.from_numpy(v)
                                            for k, v in tree["dense"].items()},
                                  "steps": tree["steps"]})
    else:
        writer.save_params(path, tree)
    sd = reader.load_state_dict(path + ".npz")
    back = reader.native_params(sd)
    flat = checkpoints.flatten_params(back)
    assert sorted(flat) == ["dense/bias", "dense/kernel", "steps"]
    for key, value in checkpoints.flatten_params(tree).items():
        np.testing.assert_array_equal(flat[key], value)
        assert flat[key].dtype == value.dtype
    assert reader.native_params({"a": np.zeros(1)}) is None
    assert checkpoints.NATIVE_FORMAT_KEY == jcheckpoints.NATIVE_FORMAT_KEY


@pytest.mark.parametrize("case", ["rgb_batch", "gray", "out_of_range", "tensor"])
def test_pil_image_matches_jax(case):
    rng = np.random.default_rng(2)
    shape = (1, 1, 5, 7) if case == "gray" else (2, 3, 5, 7)
    images = rng.uniform(-0.2 if case == "out_of_range" else 0.0, 1.0, size=shape)
    images = images.astype(np.float32)
    if case == "out_of_range":
        with pytest.warns(UserWarning, match="not in range"):
            got = pil_image(images)
        with pytest.warns(UserWarning, match="not in range"):
            want = jpil_image(images)
    else:
        got = pil_image(torch.from_numpy(images) if case == "tensor" else images)
        want = jpil_image(images)
    assert got.mode == want.mode and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="expected NCHW"):
        pil_image(images[0])
