"""``repro_torch.blocks`` — the convolution-block library (port of
``repro.blocks``).

    from repro_torch.blocks import get_block

    acc = get_block("conv3").apply_batched(x_nhwc, w_oihw, data_bits=6,
                                           coeff_bits=4)

Importing the package registers the paper's four blocks (conv1..conv4).
"""

from repro_torch.blocks.base import (BIT_RANGE, ConvBlock, fused_dot_layer,
                                     fused_dot_layer_plain,
                                     fused_dot_layer_requant,
                                     fused_dot_layer_requant_plain,
                                     packed_dot_layer, packed_dot_layer_plain,
                                     packed_dot_layer_requant,
                                     packed_dot_layer_requant_plain)
from repro_torch.blocks.paper import (CONV1, CONV2, CONV3, CONV4, Conv1Block,
                                      Conv2Block, Conv3Block, Conv4Block)
from repro_torch.blocks.registry import (BlockLike, get_block, list_blocks,
                                         register_block, unregister_block)

__all__ = [
    "BIT_RANGE", "BlockLike", "ConvBlock",
    "CONV1", "CONV2", "CONV3", "CONV4",
    "Conv1Block", "Conv2Block", "Conv3Block", "Conv4Block",
    "fused_dot_layer", "fused_dot_layer_plain",
    "fused_dot_layer_requant", "fused_dot_layer_requant_plain",
    "packed_dot_layer", "packed_dot_layer_plain",
    "packed_dot_layer_requant", "packed_dot_layer_requant_plain",
    "get_block", "list_blocks", "register_block", "unregister_block",
]
