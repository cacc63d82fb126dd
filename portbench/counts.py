"""The yardstick's arithmetic: the chip's peaks, the roofline bound, and the
operations and bytes of the model and of the serving path's hand kernels,
all from a configuration's shapes. Nothing here calls the program.

Peaks are NVIDIA's data sheet for the H100 SXM, dense, at its 700 W power
limit: 1,979 TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s of HBM3. A
multiply-accumulate counts as two operations. A deconvolution of kernel k
and stride 2 counts every input pixel's k*k contributions (four per output
pixel for k = 4), which is what a subpixel kernel computes.
"""

from __future__ import annotations

from portbench.reference.model import RESNET, blocks

PEAK_INT8_OPS = 1.979e15
PEAK_BF16_FLOPS = 0.989e15
PEAK_BYTES = 3.35e12


def bound_ms(ops: float, nbytes: float, peak_ops: float = PEAK_INT8_OPS) -> float:
    """The least milliseconds at the peaks: max(ops / peak, bytes / HBM)."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES) * 1e3


def layers(cfg: dict) -> list[tuple[str, int, int, int, int, int]]:
    """One image's convolutions as [(name, out h, out w, cin, cout, k*k
    contributions an output pixel)], the stem to the head."""
    size = cfg["image_size"]
    h = (size[1] + 1) // 2
    w = (size[0] + 1) // 2
    out = [("stem", h, w, 3, 64, 49)]
    h, w = (h + 1) // 2, (w + 1) // 2  # the 3x3 / 2 max-pool
    for name, kind, cin, planes, stride, proj in blocks(cfg["num_layers"]):
        ho, wo = (h + stride - 1) // stride, (w + stride - 1) // stride
        if kind == "bottleneck":
            out += [(f"{name}.conv1", h, w, cin, planes, 1),
                    (f"{name}.conv2", ho, wo, planes, planes, 9),
                    (f"{name}.conv3", ho, wo, planes, planes * 4, 1)]
            cout = planes * 4
        else:
            out += [(f"{name}.conv1", ho, wo, cin, planes, 9),
                    (f"{name}.conv2", ho, wo, planes, planes, 9)]
            cout = planes
        if proj:
            out.append((f"{name}.downsample", ho, wo, cin, cout, 1))
        h, w = ho, wo
    cin = blocks(cfg["num_layers"])[-1][3] * (4 if RESNET[cfg["num_layers"]][0] == "bottleneck"
                                             else 1)
    for i, (nf, k) in enumerate(zip(cfg["deconv_filters"], cfg["deconv_kernels"])):
        h, w = 2 * h, 2 * w
        out.append((f"deconv{i}", h, w, cin, nf, k * k // 4))
        cin = nf
    fk = cfg["final_conv_kernel"]
    out.append(("final", h, w, cin, cfg["num_joints"], fk * fk))
    return out


def image_macs(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward, trunk to head."""
    return sum(h * w * cin * cout * kk for _, h, w, cin, cout, kk in layers(cfg))


def trunk_macs(cfg: dict) -> int:
    """Multiply-accumulates of one image through the ResNet trunk alone."""
    return sum(h * w * cin * cout * kk for name, h, w, cin, cout, kk in layers(cfg)
               if not name.startswith(("deconv", "final")))


def bank_macs(cfg: dict, groups: int) -> int:
    """The fusion's twelve [groups * J, S] x [S, S] products."""
    if not cfg["aggre"]:
        return 0
    s = cfg["heatmap_size"][0] * cfg["heatmap_size"][1]
    return 12 * groups * cfg["num_joints"] * s * s


def request_ops(cfg: dict, groups: int, views: int) -> float:
    """Operations of one served request of ``groups`` groups: the model on
    every image and the fusion."""
    return 2.0 * (groups * views * image_macs(cfg) + bank_macs(cfg, groups))


def train_step_flops(cfg: dict, groups: int, views: int) -> float:
    """Model FLOPs of one training step: the forward's operations three
    times (forward, and the backward's two products of each layer)."""
    return 3.0 * request_ops(cfg, groups, views)


def serve_hand_kernel_bounds(cfg: dict, groups: int, views: int) -> dict[str, float]:
    """The least milliseconds of one request's hand kernels on the int8
    serving path (int8 activations and weights, f32 heatmaps), each input,
    weight and output byte counted once: deconv0 (B2), deconv1 and deconv2
    with the head (B1, two launches), the fusion's quantize pass and the
    fusion's products (B3)."""
    n = groups * views
    j = cfg["num_joints"]
    by = {name: (h, w, cin, cout, kk) for name, h, w, cin, cout, kk in layers(cfg)}

    def deconv(name):
        h, w, cin, cout, kk = by[name]
        macs = n * h * w * cin * cout * kk
        nbytes = n * (h // 2) * (w // 2) * cin + 4 * kk * cin * cout + n * h * w * cout
        return macs, nbytes

    m0, b0 = deconv("deconv0")
    m1, b1 = deconv("deconv1")
    m2, b2 = deconv("deconv2")
    h, w = by["final"][:2]
    s = h * w
    maps = n * j * s
    head_macs = maps * by["final"][2]
    # deconv2's int8 output stays on chip; the head writes f32 maps
    b2 = b2 - n * h * w * by["deconv2"][3] + j * by["final"][2] + 4 * maps
    out = {"deconv0": bound_ms(2.0 * m0, b0),
           "deconv1": bound_ms(2.0 * m1, b1),
           "deconv2+head": bound_ms(2.0 * (m2 + head_macs), b2),
           "quantize": bound_ms(0.0, 4 * maps + maps)}
    if cfg["aggre"]:
        out["fusion"] = bound_ms(2.0 * bank_macs(cfg, groups),
                                 12 * s * s + maps + 4 * maps)
    return out
