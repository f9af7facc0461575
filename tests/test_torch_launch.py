"""The port's one launch path (``repro_torch.kernels.build.launch``) on
the CPU: ``build.ENTRIES`` names every C entry of the kernel sources,
and for each entry the path refuses a tensor on ``meta`` and a
non-contiguous one, naming the entry, and counts nothing in
``build.LAUNCHES``.  The launches themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import re

import pytest
import torch

from repro_torch.kernels import build


def test_entries_name_every_c_entry_of_the_sources():
    """``extern "C" int repro_<entry>(`` in each ``csrc/<library>.cu``,
    by library, is ``build.ENTRIES``."""
    found = {e: lib for lib in build.KERNELS for e in re.findall(
        r'extern "C" int repro_(\w+)\(', (build.CSRC / f"{lib}.cu")
        .read_text())}
    assert found == build.ENTRIES


def test_library_of_refuses_an_unknown_entry():
    """Every C entry has its library in ``build.ENTRIES``; a name that is
    not one raises instead of passing for a library's."""
    assert build.library_of("fused_dot_layer_requant") == "fused_dot_layer"
    with pytest.raises(KeyError):
        build.library_of("moe_expert_gemm")


@pytest.mark.parametrize("entry", sorted(build.ENTRIES))
def test_launch_refuses_what_no_kernel_takes(entry):
    x = torch.zeros((4, 6))
    before = build.LAUNCHES.copy()
    meta = x.to("meta")
    with pytest.raises(ValueError,
                       match=f"^{entry}: no kernel for a tensor on meta"):
        build.launch(entry, (), (meta, meta), meta, 0)
    with pytest.raises(ValueError,
                       match=f"^{entry}: every tensor must be contiguous"):
        build.launch(entry, (), (x, x.t()), x, 0)
    assert build.LAUNCHES == before
