"""The yardstick's arithmetic: the chip's peaks, model FLOPs counted from a
configuration's widths (no recomputation), and each port kernel's bytes and
operations from its shapes, for the least time of a launch.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense rates.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def least_time_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """max(bytes / HBM bandwidth, operations / peak)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


# ---------------------------------------------------------------- kernels
def stream_scatter_add_bytes(n_slots: int, size: int) -> int:
    """One decode launch: each (int32 index, f32 value) slot read once, the
    f32 output written once."""
    return 8 * n_slots + 4 * size


def pair_mask_streams_bytes(rows: int, peers: int, k_masks) -> int:
    """One round's mask launch: an (int32 index, f32 value) slot written for
    every (row, peer, slot) of every leaf; the seed and sign matrices read."""
    return 8 * rows * peers * sum(int(k) for k in k_masks) + 8 * rows * peers


# integer operations of one mask slot (two murmur chains, the modulo, a
# shift, a convert, the scale), counted at the f32 rate: the data sheet
# gives no int32 rate
MASK_OPS_PER_SLOT = 25


def pair_mask_streams_ops(rows: int, peers: int, k_masks) -> int:
    return MASK_OPS_PER_SLOT * rows * peers * sum(int(k) for k in k_masks)


# ------------------------------------------------------------ model FLOPs
def vgg_forward_flops(config: dict) -> int:
    """One sample's forward: 2 FLOPs a multiply-add of every convolution and
    of the head, at the configuration's input size (pools halve H and W)."""
    h, w, cin = config["input_shape"]
    k = config["kernel_size"]
    flops = 0
    for v in config["conv_channels"]:
        if v == "M":
            h, w = h // 2, w // 2
            continue
        flops += 2 * h * w * k * k * cin * v
        cin = v
    n_in = h * w * cin
    for n_out in config["head"]:
        flops += 2 * n_in * n_out
        n_in = n_out
    return flops


def vgg_round_flops(config: dict, traffic: dict) -> int:
    """A round's model FLOPs: forward and backward (3x the forward) of every
    sample of every participant's local steps."""
    samples = (traffic["clients_per_round"] * traffic["local_steps"]
               * traffic["local_batch"])
    return 3 * vgg_forward_flops(config) * samples


def lm_matmul_params(config: dict) -> int:
    """Parameters that take part in a token's matrix products: every
    block's attention and MLP projections and the output head (the embedding
    is a gather)."""
    d, L = config["d_model"], config["n_layers"]
    hd = config["d_model"] // config["n_heads"]
    q = config["n_heads"] * hd
    kv = config["n_kv_heads"] * hd
    per_block = d * q + 2 * d * kv + q * d + 3 * d * config["d_ff"]
    return L * per_block + d * config["vocab"]


def lm_step_flops(config: dict, batch: int, seq: int) -> int:
    """A training step's model FLOPs: 6 N per token over the matrix-product
    parameters, plus causal attention's two products, forward and backward
    (3x), over the kept half of the score matrix."""
    tokens = batch * seq
    dense = 6 * lm_matmul_params(config) * tokens
    q = config["d_model"]
    attn = 3 * 2 * 2 * config["n_layers"] * batch * q * seq * seq // 2
    return dense + attn
