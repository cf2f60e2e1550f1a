"""The yardstick's count functions against the kernel table's bound column
(PERF.md, section 6) at its shapes, and the model FLOPs against hand counts."""
import json
import math

import pytest

from fedbench.frozen import counts
from fedbench.harness import manifest
from fedbench.reference import vgg

VGG = json.loads((manifest.BENCH / "configs" / "vgg16_cifar10.json")
                 .read_text())


def bound_ms(nbytes, flops=0, peak=counts.PEAK_FLOPS["float32"]):
    return 1e3 * counts.least_time_s(nbytes, flops, peak)


def test_scatter_at_yi6b_embed():
    # Yi-6B's embed in the v1 FL step on the multi-pod layout: 2
    # participants, 256 blocks, kb 2,397 top-k and 2 x 5,120 mask slots a
    # block row (the port's layout, checked below); 0.328 ms, bytes-bound
    nb, kb, km = 256, 2397, 5120
    n = 2 * nb * (kb + 2 * km)
    size = nb * -(-64000 * 4096 // nb)
    assert round(bound_ms(counts.stream_scatter_add_bytes(n, size)), 3) == 0.328


def test_embed_unit_is_the_ports():
    import chip_smoke
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf
    cfg, mesh, thgs, sa = chip_smoke.fl_config()
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", thgs, sa,
                                     lr=chip_smoke.FL_LR)
    leaves, specs, sizes, leaf_k = step.layout(tf.init_params(cfg,
                                                              device="meta"))
    units = step.units(leaves, specs, sizes, leaf_k)
    lid = [lf.path for lf in leaves].index("embed")
    assert next(u for u in units if u[0] == lid)[2:5] == (256, 2397, 5120)


def test_pair_masks_of_a_vgg16_round():
    # one launch a round over VGG16's 54 leaves, 5 clients: 0.00176 ms
    shapes = vgg.leaf_shapes(VGG)
    assert len(shapes) == 54
    kms = [max(1, int(math.prod(s) * 0.01 / 5)) for s in shapes.values()]
    ms = bound_ms(counts.pair_mask_streams_bytes(5, 5, kms),
                  counts.pair_mask_streams_ops(5, 5, kms))
    assert round(ms, 5) == 0.00176


def test_vgg16_flops_by_hand():
    # 3x3 convolutions at 32, 16, 8, 4, 2 pixels a side, 2 FLOPs a MAC
    convs = [(32, 3, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
             (8, 128, 256), (8, 256, 256), (8, 256, 256), (4, 256, 512),
             (4, 512, 512), (4, 512, 512), (2, 512, 512), (2, 512, 512),
             (2, 512, 512)]
    hand = sum(2 * h * h * 9 * ci * co for h, ci, co in convs) + 2 * 512 * 10
    assert counts.vgg_forward_flops(VGG) == hand
    assert hand == pytest.approx(0.627e9, rel=2e-3)
    traffic = {"clients_per_round": 5, "local_steps": 5, "local_batch": 50}
    assert counts.vgg_round_flops(VGG, traffic) == 3 * hand * 1250


def test_lm_flops_by_hand():
    yi = {"n_layers": 32, "d_model": 4096, "n_heads": 32, "n_kv_heads": 4,
          "head_dim": 128, "d_ff": 11008, "vocab": 64000}
    # q, o: 4096 x 4096; k, v: 4096 x 512; MLP: 3 x 4096 x 11008
    block = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008
    n = 32 * block + 4096 * 64000
    assert counts.lm_matmul_params(yi) == n
    B, T = 4, 4096
    attn = 3 * 2 * 2 * 32 * B * 4096 * T * T // 2
    assert counts.lm_step_flops(yi, B, T) == 6 * n * B * T + attn
    assert counts.lm_step_flops(yi, B, T) == pytest.approx(6.5e14, rel=0.05)
