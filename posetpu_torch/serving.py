"""The serving pipelines as a public package API.

:func:`build_serving_pipeline` packages the int8 serving configuration:

- the batch-minor, space-to-depth uint8 input contract: raw camera crops
  arrive [H/2, W/2, 12, N*V] ((h, w, c, n) byte order), and the
  (x/255 - mean)/std normalisation + input quantisation fold into one
  affine on the bytes (models/quant.make_u8_quant);
- the PTQ int8 trunk (exact int8 GEMMs), each inner deconv named in
  ``subpixel_deconvs`` through the B2 kernel (the others as the dilated int8
  conv) and deconv1 + deconv2 + the 1x1 head through the B1 kernel, so
  heatmaps come out phase-packed (ops/heatmap.phase_index_tables(levels=2));
- the grouped int8 aggregation of the reference's 12 ChannelWiseFC
  (lib/models/multiview_pose_resnet.py:16-58) through the B3 kernel, or with
  ``agg_w4=True`` the diag-split 4-bit bank through the B4 kernel, the bank
  permuted offline into the packed order;
- the reference's inference-time fuse routing (3/5 fused + 2/5 raw on h36m
  samples, lib/core/function.py:33-88) and flip test
  (lib/core/function.py:557-583): the mirror is an index permutation on the
  packed input (models/quant.mirror_s2d_hwcn), the merge static moves in
  the packed order;
- packed decode and inverse affine.

:func:`build_float_pipeline` is the float inference path, what the
reference's validate loop does with the float model: the MultiViewPose
forward, fuse routing, the flip-test merge, and final predictions decoded by
the B7 kernel.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from posetpu_torch import resolve_device
from posetpu_torch.utils.profiling import span


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


def finalize_device_params(params):
    """The JAX package's call of this name casts the s4 bank's int8 carrier
    to a 4-bit type on the device. Here the bank is already nibble-packed in
    device memory when the pipeline is built
    (ops/aggregation.aggregation_device_params_s4), so this returns
    ``params`` as they are: safe to call on any pipeline's params."""
    return params


def build_serving_pipeline(cfg, model, calib_batches, *, flip_test=False,
                           views: int = 4, subpixel_deconvs=frozenset({"deconv0"}),
                           flip_pairs=None, act4="l12", agg_w4: bool = False,
                           aggre_kernel: bool = True, device=None) -> ServingPipeline:
    """Quantize a MultiViewPose module into the int8 serving pipeline.

    cfg: the reference-schema config (NETWORK.HEATMAP_SIZE, DATASET.MEAN/STD,
    NETWORK.AGGRE). model: a MultiViewPose (``resnet`` and, when AGGRE, an
    ``aggre_layer`` bank). calib_batches: iterable of [N, H, W, 3]
    normalised float batches for PTQ calibration. ``act4="l12"`` stores the
    seven layer1/layer2 block outputs at 4 bits. ``device``: CUDA unless
    given (``"cpu"`` runs every kernel's plain version).

    ``subpixel_deconvs``: names of inner deconvs (``deconv0`` of three)
    quantized in the per-phase subpixel form and run by the B2 kernel; pass
    ``False`` for the dilated int8 conv throughout.

    ``flip_test``: False, True, or ``"premirrored"``. True mirrors the packed
    input inside ``infer`` (models/quant.mirror_s2d_hwcn) and runs both
    halves through one forward; ``"premirrored"`` does the mirror in
    :meth:`prepare`, so ``infer`` starts at the u8 affine on a
    [H/2, W/2, 12, 2*N*V] input. Same bytes, same merge
    (lib/core/function.py:557-583): equal outputs. ``flip_pairs``: joint
    pairs swapped by the merge (the union joint set's unless given).

    ``agg_w4``: store the aggregation bank diag-split at 4 bits,
    nibble-packed (half the bank bytes per request), and run the B4 kernel.

    ``aggre_kernel=False``: the aggregation runs the JAX package's XLA route
    (``posetpu/serving.py:218-246``), the plain version of B3
    (``aggregation_grouped_plain``: ``torch._int_mm`` on gathered operands)
    or of B4 (``aggregation_grouped_s4_plain``), on the card as on the CPU;
    the int32 products are exact, so the outputs equal the kernels'."""
    from posetpu_torch.core.inference import (
        final_preds_packed,
        flip_test_merge_packed,
        fuse_routing_jns,
    )
    from posetpu_torch.data.base import union_flip_pairs
    from posetpu_torch.models.quant import (
        make_u8_quant,
        mirror_s2d_hwcn,
        permute_aggregation_packed,
        permute_aggregation_packed_s4,
        quantize_aggregation_grouped,
        quantize_aggregation_grouped_s4,
        quantize_pose_resnet,
    )
    from posetpu_torch.models.multiview import require_pose_resnet
    from posetpu_torch.ops import aggregation as agg
    from posetpu_torch.ops.heatmap import phase_index_tables

    require_pose_resnet(model, "the int8 serving pipeline")
    if flip_test not in (False, True, "premirrored"):
        raise ValueError(f"flip_test must be False, True, or 'premirrored'; "
                         f"got {flip_test!r} (a typo string would be truthy and "
                         f"split/merge a batch that was never doubled)")
    dev = resolve_device(device)

    hm_h, hm_w = int(cfg.NETWORK.HEATMAP_SIZE[1]), int(cfg.NETWORK.HEATMAP_SIZE[0])
    if act4 == "l12":
        act4 = tuple(f"layer1_{i}.out" for i in range(3)) + tuple(
            f"layer2_{i}.out" for i in range(4))
    qparams, qfwd = quantize_pose_resnet(model.resnet, calib_batches,
                                         subpixel_deconvs=subpixel_deconvs,
                                         act4=act4 or (), act4_mode="s4",
                                         jns_head="phase", phase_kernel=2,
                                         stem_s2d="pre", device=dev)
    tables = phase_index_tables((hm_h, hm_w), levels=2)
    qagg = None
    if bool(cfg.NETWORK.AGGRE) and model.aggre_layer is not None:
        bank = model.aggre_layer.weight
        if agg_w4:
            # diag-split 4-bit residual bank, nibble-packed on the device:
            # half the bank bytes per request; the diagonal stays exact f32
            qagg = agg.aggregation_device_params_s4(permute_aggregation_packed_s4(
                quantize_aggregation_grouped_s4(bank), tables), dev)
        else:
            qagg = agg.aggregation_device_params(permute_aggregation_packed(
                quantize_aggregation_grouped(bank), tables), dev)
    mean, std = cfg.DATASET.MEAN, cfg.DATASET.STD
    pairs = tuple(tuple(p) for p in (flip_pairs or union_flip_pairs()))
    params = {"q": qparams, "qagg": qagg}

    def aggregate(qagg, raw):
        # looked up at call time, so a caller may wrap the module's functions
        s4 = "wq4" in qagg  # the diag-split bank (agg_w4=True)
        if aggre_kernel:
            fn = agg.aggregation_grouped_s4 if s4 else agg.aggregation_grouped
        else:
            fn = agg.aggregation_grouped_s4_plain if s4 else agg.aggregation_grouped_plain
        return fn(qagg, raw)

    @torch.no_grad()
    def infer(params, x, center, scale, is_h36m):
        with span("serve.infer"):
            if flip_test is True:
                x = torch.cat([x, mirror_s2d_hwcn(x)], dim=3)
            # premirrored: x arrives [H/2, W/2, 12, 2*N*V], mirrored by prepare
            flat = x.permute(3, 0, 1, 2)  # [N*V, H/2, W/2, 12]: bytes already N-minor
            with span("serve.u8_affine"):
                x_q = make_u8_quant(params["q"], mean, std)(flat).contiguous()
            hm = qfwd(params["q"], x_q)  # [J, N*V(*2), S] packed
            if flip_test:
                hm, hm_f = hm.split(hm.shape[1] // 2, dim=1)
                hm = flip_test_merge_packed(hm, hm_f, pairs, (hm_h, hm_w),
                                            levels=tables["levels"])
            n = hm.shape[1] // views
            raw = hm.reshape(hm.shape[0], n, views, hm.shape[-1])
            out = raw
            if params["qagg"] is not None:
                with span("serve.fuse"):
                    out = fuse_routing_jns(raw, aggregate(params["qagg"], raw), is_h36m)
            with span("serve.decode"):
                return final_preds_packed(out, center, scale, (hm_h, hm_w), tables)

    def prepare(images: np.ndarray) -> torch.Tensor:
        # pack on the device: for 128 images at 256^2 the strided 25 MB
        # transpose took 180 ms in numpy on an H100 machine's host and 4 ms
        # (upload included) on the card (chip_smoke.py, PERF.md)
        n, v, h, w, c = images.shape
        with span("serve.prepare", bytes=images.nbytes):
            packed = pack_hwcn(torch.from_numpy(images.reshape(n * v, h, w, c)).to(dev))
            if flip_test == "premirrored":
                # the mirrored half rides in the upper batch-minor indices
                packed = torch.cat([packed, mirror_s2d_hwcn(packed)], dim=3)
            return packed

    return ServingPipeline(infer=infer, params=params, prepare=prepare,
                           views=views, flip_test=flip_test)


def build_float_pipeline(cfg, model, *, flip_test: bool = False, views: int = 4,
                         device=None) -> ServingPipeline:
    """The float inference path: what the reference's validate loop does
    (lib/core/function.py:33-88, 557-583) with a MultiViewPose module.

    infer(params, images, center, scale, is_h36m) -> (preds [N, V, J, 2],
    maxvals [N, V, J]): images [N, V, H, W, 3] normalised floats from
    :meth:`prepare`; the forward (both orientations in one batch under
    ``flip_test``), fuse routing where the model aggregates and
    ``cfg.TEST.FUSE_OUTPUT`` is set, the flip-test merge
    (``cfg.TEST.SHIFT_HEATMAP``), then ``final_preds``, which decodes
    through the B7 kernel on a CUDA tensor. ``params`` is the module's state
    dict, loaded into the module when ``infer`` is handed another one.
    ``device``: CUDA unless given."""
    from posetpu_torch.core.inference import final_preds, flip_test_merge, fuse_routing
    from posetpu_torch.data.base import union_flip_pairs
    from posetpu_torch.models.quant import _full_fp32

    if flip_test not in (False, True):
        raise ValueError(f"flip_test must be False or True; got {flip_test!r}")
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(dev).eval()  # the caller's module stays where it is
    is_aggre = bool(cfg.NETWORK.AGGRE) and model.aggre_layer is not None
    fuse_output = bool(cfg.TEST.FUSE_OUTPUT)
    shift = bool(cfg.TEST.SHIFT_HEATMAP)
    post = bool(cfg.TEST.POST_PROCESS)
    pairs = tuple(tuple(p) for p in union_flip_pairs())
    params = model.state_dict()

    def routed(x, mask):
        raw, fused, _, _ = model(x)  # [N, V, h, w, J]
        to_jhw = lambda t: t.permute(0, 1, 4, 2, 3)
        if is_aggre and fuse_output:
            return fuse_routing(to_jhw(raw), to_jhw(fused), mask)
        return to_jhw(raw)

    @torch.no_grad()
    def infer(params_, x, center, scale, is_h36m):
        if params_ is not params:
            model.load_state_dict(params_)
        n = x.shape[0]
        with _full_fp32():
            if flip_test:
                out2 = routed(torch.cat([x, x.flip(-2)], dim=0),
                              torch.cat([is_h36m, is_h36m], dim=0))
                output = flip_test_merge(out2[:n], out2[n:], pairs, shift=shift)
            else:
                output = routed(x, is_h36m)
        return final_preds(output, center, scale, post_process=post)

    def prepare(images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(images, np.float32)).to(dev)

    return ServingPipeline(infer=infer, params=params, prepare=prepare,
                           views=views, flip_test=flip_test)
