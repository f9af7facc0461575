"""Operations and bytes the served work needs, from shapes alone.

The rules follow the port's ``bound_ms`` arithmetic: a 3×3 convolution
layer needs 2·H·W·Cin·Cout·9 integer operations per image and reads each
input byte once and writes each output byte once; a routed MoE token needs
its router projection (2·D·E) and, for each of its top-k experts, the
gated FFN's three products (3·2·D·F).  Empty capacity slots and padded
bucket rows are waste, not work, so nothing here counts them.
"""

from __future__ import annotations

from typing import Dict

from portbench.yardstick import peaks


def container_bytes(bits: int) -> int:
    """Bytes of the integer container a ``bits``-bit value is served in."""
    return 1 if bits <= 8 else 2


def conv_layer_ops(h: int, w: int, cin: int, cout: int) -> int:
    """Integer operations (a multiply and an add each) of one 3×3 layer
    over one image."""
    return 2 * h * w * cin * cout * 9


def cnn_ops_per_image(net: Dict) -> int:
    """Operations of every layer of ``net`` (a configuration's
    ``network``) over one image."""
    return sum(conv_layer_ops(net["img_h"], net["img_w"], l["in_channels"],
                              l["out_channels"]) for l in net["layers"])


def conv_layer_bytes(n: int, h: int, w: int, layer: Dict,
                     out_bits: int) -> int:
    """Bytes one launch of a layer over ``n`` images must move: its input
    activations and weights read once, its output written once, each in
    its serving container."""
    cin, cout = layer["in_channels"], layer["out_channels"]
    return (n * h * w * cin * container_bytes(layer["data_bits"])
            + cout * cin * 9 * container_bytes(layer["coeff_bits"])
            + n * h * w * cout * container_bytes(out_bits))


def conv_layer_bound_s(n: int, net: Dict, i: int) -> float:
    """Least time the card could take for layer ``i`` of ``net`` over
    ``n`` images: the larger of its bytes at HBM bandwidth and its
    operations at the int8 tensor-core peak."""
    layer = net["layers"][i]
    h, w = net["img_h"], net["img_w"]
    nbytes = conv_layer_bytes(n, h, w, layer, layer["data_bits"])
    ops = n * conv_layer_ops(h, w, layer["in_channels"],
                             layer["out_channels"])
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT8_OPS_PER_S)


def moe_flops_per_token_layer(d_model: int, num_experts: int, top_k: int,
                              d_ff: int, gated: bool = True) -> int:
    """FLOPs one routed token needs in one MoE layer: the router
    projection and its top-k experts' FFN products."""
    products = 3 if gated else 2
    return 2 * d_model * num_experts + top_k * products * 2 * d_model * d_ff


def moe_flops_per_token(experts: Dict) -> int:
    """FLOPs one token needs through every MoE layer of a configuration's
    ``experts`` block."""
    return experts["num_hidden_layers"] * moe_flops_per_token_layer(
        experts["hidden_size"], experts["num_experts"],
        experts["num_experts_per_tok"], experts["moe_intermediate_size"],
        experts.get("gated", True))

