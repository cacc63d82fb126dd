"""The int8 serving pipeline as a public package API.

One builder packages the serving configuration:

- the batch-minor, space-to-depth uint8 input contract: raw camera crops
  arrive [H/2, W/2, 12, N*V] ((h, w, c, n) byte order), and the
  (x/255 - mean)/std normalisation + input quantisation fold into one
  affine on the bytes (models/quant.make_u8_quant);
- the PTQ int8 trunk (exact int8 GEMMs), deconv0 through the B2 kernel and
  deconv1 + deconv2 + the 1x1 head through the B1 kernel, so heatmaps come
  out phase-packed (ops/heatmap.phase_index_tables(levels=2));
- the grouped int8 aggregation of the reference's 12 ChannelWiseFC
  (lib/models/multiview_pose_resnet.py:16-58) through the B3 kernel, with the
  bank permuted offline into the packed order;
- the reference's inference-time fuse routing (3/5 fused + 2/5 raw on h36m
  samples, lib/core/function.py:33-88), packed decode and inverse affine.

Not in this slice (they raise ``NotImplementedError``): ``flip_test`` True or
``"premirrored"``, the s4 aggregation bank (``agg_w4=True``), and
``subpixel_deconvs`` other than ``{"deconv0"}``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from posetpu_torch import resolve_device


class ServingPipeline(NamedTuple):
    """A built serving pipeline.

    infer(params, x_u8, center, scale, is_h36m) -> (preds, maxvals):
        x_u8 the packed uint8 input from :meth:`prepare`, center/scale
        [N, V, 2] the reference crop geometry, is_h36m [N] f32 the
        fuse-routing source mask; preds [N, V, J, 2] source-image coords,
        maxvals [N, V, J]. The input affine is derived from ``params``.
    params: the quantized trunk, kernel argument packs and aggregation bank.
    prepare(images_u8 [N, V, H, W, 3] numpy) -> packed [H/2, W/2, 12, N*V]
        uint8 tensor, packed on the pipeline's device.
    """

    infer: Callable
    params: Any
    prepare: Callable
    views: int
    flip_test: bool | str


def pack_hwcn(images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [H/2, W/2, 12, N] space-to-depth packed,
    batch-minor — the serving input contract — on the images' device."""
    n, h, w, c = images.shape
    x = images.reshape(n, h // 2, 2, w // 2, 2, c)
    x = x.permute(1, 3, 2, 4, 5, 0)  # [H/2, W/2, 2, 2, C, N]
    return x.reshape(h // 2, w // 2, 4 * c, n).contiguous()


def build_serving_pipeline(cfg, model, calib_batches, *, flip_test=False,
                           views: int = 4, subpixel_deconvs=frozenset({"deconv0"}),
                           act4="l12", agg_w4: bool = False,
                           device=None) -> ServingPipeline:
    """Quantize a MultiViewPose module into the int8 serving pipeline.

    cfg: the reference-schema config (NETWORK.HEATMAP_SIZE, DATASET.MEAN/STD,
    NETWORK.AGGRE). model: a MultiViewPose (``resnet`` and, when AGGRE, an
    ``aggre_layer`` bank). calib_batches: iterable of [N, H, W, 3]
    normalised float batches for PTQ calibration. ``act4="l12"`` stores the
    seven layer1/layer2 block outputs at 4 bits. ``device``: CUDA unless
    given (``"cpu"`` runs every kernel's plain version)."""
    from posetpu_torch.core.inference import final_preds_packed, fuse_routing_jns
    from posetpu_torch.models.quant import (
        make_u8_quant,
        permute_aggregation_packed,
        quantize_aggregation_grouped,
        quantize_pose_resnet,
    )
    from posetpu_torch.ops import aggregation as agg
    from posetpu_torch.ops.heatmap import phase_index_tables

    if flip_test not in (False, True, "premirrored"):
        raise ValueError(f"flip_test must be False, True, or 'premirrored'; "
                         f"got {flip_test!r}")
    if flip_test:
        raise NotImplementedError("flip_test is not ported yet (ROADMAP.md)")
    if agg_w4:
        raise NotImplementedError("agg_w4 (s4 aggregation bank) is not ported yet")
    if set(subpixel_deconvs) != {"deconv0"}:
        raise NotImplementedError("only subpixel_deconvs={'deconv0'} is ported")
    dev = resolve_device(device)

    hm_h, hm_w = int(cfg.NETWORK.HEATMAP_SIZE[1]), int(cfg.NETWORK.HEATMAP_SIZE[0])
    if act4 == "l12":
        act4 = tuple(f"layer1_{i}.out" for i in range(3)) + tuple(
            f"layer2_{i}.out" for i in range(4))
    qparams, qfwd = quantize_pose_resnet(model.resnet, calib_batches,
                                         subpixel_deconvs=subpixel_deconvs,
                                         act4=act4 or (), device=dev)
    tables = phase_index_tables((hm_h, hm_w), levels=2)
    qagg = None
    if bool(cfg.NETWORK.AGGRE) and model.aggre_layer is not None:
        qagg = agg.aggregation_device_params(permute_aggregation_packed(
            quantize_aggregation_grouped(model.aggre_layer.weight), tables), dev)
    mean, std = cfg.DATASET.MEAN, cfg.DATASET.STD
    params = {"q": qparams, "qagg": qagg}

    @torch.no_grad()
    def infer(params, x, center, scale, is_h36m):
        u8_quant = make_u8_quant(params["q"], mean, std)
        flat = x.permute(3, 0, 1, 2)  # [N*V, H/2, W/2, 12]: bytes already N-minor
        hm = qfwd(params["q"], u8_quant(flat).contiguous())  # [J, N*V, S] packed
        n = hm.shape[1] // views
        raw = hm.reshape(hm.shape[0], n, views, hm.shape[-1])
        if params["qagg"] is not None:
            fused = agg.aggregation_grouped(params["qagg"], raw)
            out = fuse_routing_jns(raw, fused, is_h36m)
        else:
            out = raw
        return final_preds_packed(out, center, scale, (hm_h, hm_w), tables)

    def prepare(images: np.ndarray) -> torch.Tensor:
        # pack on the device: for 128 images at 256^2 the strided 25 MB
        # transpose took 180 ms in numpy on an H100 machine's host and 4 ms
        # (upload included) on the card (chip_smoke.py, PERF.md)
        n, v, h, w, c = images.shape
        return pack_hwcn(torch.from_numpy(images.reshape(n * v, h, w, c)).to(dev))

    return ServingPipeline(infer=infer, params=params, prepare=prepare,
                           views=views, flip_test=flip_test)
