"""The port's CUDA library module on the CPU: which op module declares
which C entry point, how the library's file name follows its sources, and
that the GroupNorm op reaches the library without the flash module. The
kernels themselves are built and checked on the card by chip_smoke.py."""

import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from perceptor_tpu_torch.ops import cuda_library
from perceptor_tpu_torch.ops import flash_attention_kernel as fa
from perceptor_tpu_torch.ops import groupnorm as gn
from perceptor_tpu_torch.ops import layernorm as ln

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "perceptor_tpu_torch" / "csrc"


def test_every_entry_point_is_declared_once_and_the_name_follows_the_sources(tmp_path):
    """Each `extern "C"` function of csrc/*.cu has its argument types in
    exactly one of the three op modules, which the library module holds; and
    editing any .cu or .cuh of a copy of csrc/ gives the library another
    path, so a build never loads a stale library."""
    entry_points = {
        name for src in CSRC.glob("*.cu")
        for name in re.findall(r'extern "C" int (\w+)\(', src.read_text())
    }
    declared = [m._ARGTYPES.keys() for m in (fa, gn, ln)]
    assert sum(len(names) for names in declared) == len(set().union(*declared))
    assert set().union(*declared) == entry_points
    assert cuda_library._ARGTYPES == {**fa._ARGTYPES, **gn._ARGTYPES, **ln._ARGTYPES}

    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    base = cuda_library.library_path(copy)
    assert base == cuda_library.library_path(CSRC)
    assert base.parent == REPO / "build" and base.name.startswith("libperceptor_kernels_")
    sources = sorted(p for p in copy.iterdir() if p.suffix in (".cu", ".cuh"))
    assert {p.suffix for p in sources} == {".cu", ".cuh"}
    seen = {base}
    for src in sources:
        text = src.read_text()
        src.write_text(text + "\n")
        seen.add(cuda_library.library_path(copy))
        src.write_text(text)
        assert cuda_library.library_path(copy) == base
    assert len(seen) == len(sources) + 1


def test_groupnorm_imports_without_the_flash_module():
    """The GroupNorm op gets its library from `cuda_library`, not from the
    flash module. Importing the package imports every op (ops.attention
    takes the flash module), so the two package modules are stubbed and
    groupnorm is imported alone; its CPU path then runs and loads nothing."""
    code = textwrap.dedent(f"""
        import sys, types
        root = {str(REPO / "perceptor_tpu_torch")!r}
        for name, path in (("perceptor_tpu_torch", root), ("perceptor_tpu_torch.ops", root + "/ops")):
            module = types.ModuleType(name)
            module.__path__ = [path]
            sys.modules[name] = module
        import torch
        from perceptor_tpu_torch.ops import groupnorm as gn
        x = torch.randn(2, 8, 3, 3)
        gn.fused_group_norm_act(x, torch.ones(8), torch.zeros(8), 4)
        assert "perceptor_tpu_torch.ops.flash_attention_kernel" not in sys.modules
        assert sys.modules["perceptor_tpu_torch.ops.cuda_library"]._lib is None
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"
