"""The paper's own workload: a library of parameterizable 3x3 convolution
blocks swept over data/coefficient bit widths (3..16), per §3.2 of the paper.

Port of ``repro.configs.paper_conv``, verbatim.  This is not an LM arch;
it configures the block-level resource sweep (core/synth.py) that
reproduces Tables 3-5.
"""

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ConvSweepConfig:
    name: str = "paper-conv-sweep"
    blocks: Tuple[str, ...] = ("conv1", "conv2", "conv3", "conv4")
    data_bits: Tuple[int, ...] = tuple(range(3, 17))
    coeff_bits: Tuple[int, ...] = tuple(range(3, 17))
    # image tile the blocks stream over (one output tile per grid step)
    tile_h: int = 16
    tile_w: int = 128
    channels: int = 8              # input channel depth per block instance
    kernel: int = 3


SWEEP = ConvSweepConfig()

# Reduced sweep for CI's `-m sweep` job and the deployment planner's
# end-to-end tests: one logic block + one dual-output MXU block over a
# 6×6 bit grid — 72 kernel traces instead of 784.  The grid straddles
# the int8/int16 container boundary with three points on each side so
# the segmented container models still lock onto the step exactly (a
# sparser grid lets a plain polynomial squeak past the R² gate and
# mispredict by ~40% at the boundary).
REDUCED_SWEEP = ConvSweepConfig(
    name="paper-conv-sweep-reduced",
    blocks=("conv1", "conv4"),
    data_bits=(4, 6, 8, 10, 12, 16),
    coeff_bits=(4, 6, 8, 10, 12, 16),
)
