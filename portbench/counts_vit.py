"""The yardstick's arithmetic for ViTPose: the model's operations and the
attention's bound, from a configuration's shapes. Nothing here calls the
program. Peaks and the roofline as :mod:`portbench.counts`; a
multiply-accumulate counts as two operations; a stride-2 deconvolution of
kernel k counts every input pixel's k*k contributions.
"""

from __future__ import annotations

from portbench.counts import PEAK_BF16_FLOPS, PEAK_BYTES, bank_macs
from portbench.reference.vitpose import grid

BF16 = 2  # bytes an element of the attention's operands


def tokens(cfg: dict) -> int:
    gh, gw = grid(cfg)
    return gh * gw


def image_macs(cfg: dict) -> dict[str, int]:
    """Multiply-accumulates of one image's forward by part: the patch
    embedding, the blocks (and within them the attention's two products),
    the head."""
    c, t, p = cfg["embed_dim"], tokens(cfg), cfg["patch_size"]
    hidden = int(c * cfg["mlp_ratio"])
    block = t * (3 * c * c + c * c + 2 * c * hidden) + 2 * t * t * c
    gh, gw = grid(cfg)
    head, cin, h, w = 0, c, gh, gw
    for nf, k in zip(cfg["deconv_filters"], cfg["deconv_kernels"]):
        head += h * w * k * k * cin * nf
        h, w, cin = 2 * h, 2 * w, nf
    head += h * w * cfg["final_conv_kernel"] ** 2 * cin * cfg["num_joints"]
    return {"patch_embed": t * 3 * p * p * c, "blocks": cfg["depth"] * block,
            "attention_products": cfg["depth"] * 2 * t * t * c, "head": head}


def train_step_flops(cfg: dict, groups: int, views: int) -> float:
    """Model FLOPs of one training step: the forward's operations (every
    image through the model, and the fusion's products) three times."""
    m = image_macs(cfg)
    per_image = m["patch_embed"] + m["blocks"] + m["head"]
    return 3.0 * 2.0 * (groups * views * per_image + bank_macs(cfg, groups))


def attention_bound_ms(cfg: dict, images: int) -> dict[str, float]:
    """The least milliseconds a step of the attention's kernels (``softmax(q
    k^T / sqrt(d)) v`` over every block) can take at the peaks, forward and
    backward each the larger of its FLOPs over 989 TFLOP/s and its bytes
    over 3.35 TB/s. Forward: the two products (4 T^2 C FLOPs an image),
    reading q, k, v and writing o. Backward: twice the forward's products,
    reading q, k, v, o and o's gradient and writing those of q, k and v. The
    same work whatever kernel does it; bf16 operands."""
    c, t, depth = cfg["embed_dim"], tokens(cfg), cfg["depth"]
    fwd_flops = depth * images * 4.0 * t * t * c
    tensor = images * t * c * BF16
    fwd = max(fwd_flops / PEAK_BF16_FLOPS, depth * 4 * tensor / PEAK_BYTES)
    bwd = max(2 * fwd_flops / PEAK_BF16_FLOPS, depth * 8 * tensor / PEAK_BYTES)
    return {"forward": fwd * 1e3, "backward": bwd * 1e3}
