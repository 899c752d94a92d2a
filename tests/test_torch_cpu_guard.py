"""The CPU `torch.exp` first-call guard, imported by every tests/test_torch_*.py.

In a CPU process that has imported jax, the first multi-threaded torch.exp
(alone, or inside logsumexp or a softmax) sometimes returns a chunk of
values up to ~1.5e-4 relative off, about half the elements, while the
matmul before it is exact: 7 of 24 fresh processes under load, 0 of 72 in a
quieter batch, and never a later call (0 of 4800). The cause is not known.
One throwaway call here, at import, keeps every fp32 comparison of the
importing files on the settled kernel; every xdist worker makes it while
collecting. `test_torch_flash_attention.py::test_cpu_exp_is_exact_after_one_call`
checks what this relies on.
"""

import torch

torch.set_num_threads(2)
FIRST_EXP = torch.exp(torch.randn(2, 256, 256))


def test_the_throwaway_exp_was_made_at_import():
    assert FIRST_EXP.shape == (2, 256, 256) and torch.get_num_threads() == 2
