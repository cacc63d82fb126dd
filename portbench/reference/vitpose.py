"""The plain reference of ViTPose-H as the multi-view fusion model's
backbone, and of its training step, in plain PyTorch.

ViTPose (Xu et al. 2022, arXiv:2204.12484; ``ViTPose_huge_coco_256x192.py``
of github.com/ViTAE-Transformer/ViTPose) over the four views of a group,
the fusion bank and routing of :mod:`portbench.reference.model`, the losses
of :mod:`portbench.reference.train`, and ViTPose's AdamW. Written from the
published description; functional, the weights a dict of tensors by the
names of :func:`param_spec` (the program's). It imports nothing of the
program.

- Patch embedding ``conv2d(3, C, p, stride p, padding 2)``, then ``x +
  pos[:, 1:] + pos[:, :1]``.
- ``depth`` pre-norm blocks: ``x = x + DP_i(Attn(LN1(x)))``, ``x = x +
  DP_i(MLP(LN2(x)))``, LayerNorm eps 1e-6; attention written out as
  ``softmax(q k^T / sqrt(d)) v`` over ``heads`` heads of ``d = C / heads``;
  MLP ``Linear(C, 4C)``, exact GELU, ``Linear(4C, C)``. ``DP_i``: the
  branch times ``keep[i]``, an image's factor (0, or 1 / (1 - rate_i) at
  ``rate_i = linspace(0, drop_path_rate, depth)[i]``, kept where a uniform
  draw is at least the rate).
- The last LayerNorm, the tokens back to a map, two stride-2 4x4
  deconvolutions each with BatchNorm and ReLU, a 1x1 convolution with bias
  (TopdownHeatmapSimpleHead). BatchNorm as the ResNet reference's.
- AdamW (torch.optim.AdamW): b1 0.9, b2 0.999, eps 1e-8, bias-corrected
  moments, the decoupled decay ``lr_p * wd * p``; the gradient first
  clipped at a global L2 norm (``clip_grad_norm_``: times ``min(1, max /
  (norm + 1e-6))``); ``lr_p`` the rate under mmcv's linear warm-up by
  iterations (``1 - (1 - i / iters) * (1 - ratio)`` at step i, from 0)
  times ``layer_decay ** (depth + 1 - layer)``, the layer 0 for the patch
  embedding and ``pos``, i + 1 for block i, depth + 1 for the rest.

Departures from the published description: 256x256 inputs with 16 joints
and the multi-view fusion (the configuration's ``assumed``); no decay on
parameters of one dimension and on ``pos`` by this rule alone (ViTPose's
``custom_keys`` name biases, ``pos_embed`` and norms, which it covers);
the fusion bank, outside the backbone, at scale 1 with decay; the
drop-path draws come as an argument, made as the program draws them
(:func:`drop_keep`); the weights are seeded, not trained.

``cast``: None, or a function applied wherever a lower-precision run
stores a tensor: every operand and output of a matrix product, a
convolution, a deconvolution and the fusion's products, the attention's
probabilities, every LayerNorm and BatchNorm output and every residual sum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import model as M
from portbench.reference.train import ADAM_B1, ADAM_B2, ADAM_EPS, joints_mse

LN_EPS = 1e-6


def grid(cfg: dict) -> tuple[int, int]:
    """(rows, columns) of the patch grid."""
    p, pad = cfg["patch_size"], cfg["patch_padding"]
    w, h = cfg["image_size"]
    return (h + 2 * pad - p) // p + 1, (w + 2 * pad - p) // p + 1


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """[(name, shape, role)] of every parameter and BatchNorm statistic.
    Roles: ``pos``, ``patch.weight``, ``patch.bias``, ``ln.weight``,
    ``ln.bias``, ``linear.weight``, ``linear.bias``, ``deconv``,
    ``bn.weight``, ``bn.bias``, ``bn.mean``, ``bn.var``, ``head.weight``,
    ``head.bias``, ``bank``."""
    c, p = cfg["embed_dim"], cfg["patch_size"]
    hidden = int(c * cfg["mlp_ratio"])
    gh, gw = grid(cfg)
    spec = [("vit.pos_embed", (1, 1 + gh * gw, c), "pos"),
            ("vit.patch_embed.weight", (c, 3, p, p), "patch.weight"),
            ("vit.patch_embed.bias", (c,), "patch.bias")]

    def ln(name):
        spec.extend([(f"{name}.weight", (c,), "ln.weight"), (f"{name}.bias", (c,), "ln.bias")])

    def linear(name, o, i):
        spec.extend([(f"{name}.weight", (o, i), "linear.weight"),
                     (f"{name}.bias", (o,), "linear.bias")])

    for b in range(cfg["depth"]):
        blk = f"vit.blocks.{b}"
        ln(f"{blk}.norm1")
        linear(f"{blk}.attn.qkv", 3 * c, c)
        linear(f"{blk}.attn.proj", c, c)
        ln(f"{blk}.norm2")
        linear(f"{blk}.mlp.fc1", hidden, c)
        linear(f"{blk}.mlp.fc2", c, hidden)
    ln("vit.last_norm")
    cin = c
    for i, (nf, k) in enumerate(zip(cfg["deconv_filters"], cfg["deconv_kernels"])):
        spec.append((f"vit.deconv{i}_conv.weight", (cin, nf, k, k), "deconv"))
        for leaf, role in (("weight", "bn.weight"), ("bias", "bn.bias"),
                           ("running_mean", "bn.mean"), ("running_var", "bn.var")):
            spec.append((f"vit.deconv{i}_bn.{leaf}", (nf,), role))
        cin = nf
    fk = cfg["final_conv_kernel"]
    spec.append(("vit.final_layer.weight", (cfg["num_joints"], cin, fk, fk), "head.weight"))
    spec.append(("vit.final_layer.bias", (cfg["num_joints"],), "head.bias"))
    if cfg["aggre"]:
        s = cfg["heatmap_size"][0] * cfg["heatmap_size"][1]
        spec.append(("aggre_layer.weight", (12, s, s), "bank"))
    return spec


def drop_rates(cfg: dict) -> list[float]:
    """Each block's drop-path rate: ``linspace(0, drop_path_rate, depth)``."""
    return torch.linspace(0, cfg["drop_path_rate"], cfg["depth"], device="cpu").tolist()


def drop_keep(cfg: dict, n: int, gen: torch.Generator) -> list:
    """One training forward's drop-path factors, a block each [n, 1, 1]:
    one ``torch.rand(n)`` a block from ``gen``, in block order; 1 / (1 -
    rate) where the draw is at least the rate, else 0."""
    out = []
    for rate in drop_rates(cfg):
        u = torch.rand(n, generator=gen, device=gen.device)
        out.append(((u >= rate).float() / (1.0 - rate)).view(n, 1, 1))
    return out


def layer_of(name: str, depth: int) -> int:
    """A parameter's layer for the lr decay (ViTPose's ``get_num_layer_for_vit``)."""
    parts = name.split(".")
    if parts[0] == "vit" and parts[1] in ("patch_embed", "pos_embed"):
        return 0
    if parts[0] == "vit" and parts[1] == "blocks":
        return int(parts[2]) + 1
    return depth + 1


def decays(name: str, shape) -> bool:
    """Whether AdamW decays the parameter: two or more dimensions, not ``pos``."""
    return len(shape) > 1 and not name.endswith("pos_embed")


class _Net:
    def __init__(self, w, cfg, train: bool, cast):
        self.w, self.cfg, self.train = w, cfg, train
        self.cast = cast or (lambda t: t)
        self.stats = {}

    def linear(self, x, name):
        c = self.cast
        return c(c(x) @ c(self.w[f"{name}.weight"]).t() + self.w[f"{name}.bias"])

    def ln(self, x, name):
        return self.cast(F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                                      self.w[f"{name}.bias"], LN_EPS))

    def attention(self, x, blk):
        n, t, c = x.shape
        heads = self.cfg["num_heads"]
        d = c // heads
        qkv = self.linear(x, f"{blk}.attn.qkv").view(n, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        s = self.cast(self.cast(q) @ self.cast(k).transpose(-2, -1)) / math.sqrt(d)
        a = self.cast(torch.softmax(s, dim=-1))
        o = self.cast(a @ self.cast(v))
        return self.linear(o.transpose(1, 2).reshape(n, t, c), f"{blk}.attn.proj")

    def mlp(self, x, blk):
        h = F.gelu(self.linear(x, f"{blk}.mlp.fc1"))
        return self.linear(h, f"{blk}.mlp.fc2")

    def block(self, x, b, keep):
        blk = f"vit.blocks.{b}"
        a = self.attention(self.ln(x, f"{blk}.norm1"), blk)
        x = self.cast(x + (a if keep is None else a * keep))
        m = self.mlp(self.ln(x, f"{blk}.norm2"), blk)
        return self.cast(x + (m if keep is None else m * keep))

    def bn(self, x, name):
        p = f"vit.{name}."
        if not self.train:
            return self.cast(F.batch_norm(x, self.w[p + "running_mean"],
                                          self.w[p + "running_var"], self.w[p + "weight"],
                                          self.w[p + "bias"], False, 0.0, M.BN_EPS))
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self.stats[p + "running_mean"] = (M.BN_KEEP * self.w[p + "running_mean"]
                                              + (1 - M.BN_KEEP) * mean)
            self.stats[p + "running_var"] = (M.BN_KEEP * self.w[p + "running_var"]
                                             + (1 - M.BN_KEEP) * var)
        return self.cast(F.batch_norm(x, None, None, self.w[p + "weight"],
                                      self.w[p + "bias"], True, 0.0, M.BN_EPS))


def vitpose(w, x, cfg: dict, *, train: bool, cast=None, checkpoint: bool = False, keep=None):
    """ViTPose on NHWC images [N, H, W, 3] -> (heatmaps [N, h, w, J], new
    running averages, empty in evaluation). ``keep``: the drop-path factors
    a block (:func:`drop_keep`), or None for none. ``checkpoint``: keep only
    each block's input for the backward pass and compute the block again
    there (same values, less memory)."""
    net = _Net(w, cfg, train, cast)
    c = net.cast
    p, pad = cfg["patch_size"], cfg["patch_padding"]
    e = c(F.conv2d(c(x.permute(0, 3, 1, 2)), c(w["vit.patch_embed.weight"]),
                   w["vit.patch_embed.bias"], p, pad))
    n, ch, gh, gw = e.shape
    pos = w["vit.pos_embed"]
    t = c(e.flatten(2).transpose(1, 2) + (pos[:, 1:] + pos[:, :1]))
    for b in range(cfg["depth"]):
        k = None if keep is None else keep[b]
        if checkpoint and train:
            t = torch.utils.checkpoint.checkpoint(net.block, t, b, k, use_reentrant=False)
        else:
            t = net.block(t, b, k)
    h = net.ln(t, "vit.last_norm").transpose(1, 2).reshape(n, ch, gh, gw)
    for i, k in enumerate(cfg["deconv_kernels"]):
        padding, out_pad = {4: (1, 0), 3: (1, 1), 2: (0, 0)}[k]
        h = c(F.conv_transpose2d(c(h), c(w[f"vit.deconv{i}_conv.weight"]), None, 2, padding,
                                 out_pad))
        h = F.relu(net.bn(h, f"deconv{i}_bn"))
    wt, bias = w["vit.final_layer.weight"], w["vit.final_layer.bias"]
    h = c(F.conv2d(c(h), c(wt), bias, 1, (wt.shape[-1] - 1) // 2))
    return h.permute(0, 2, 3, 1), net.stats


def forward(w, views, cfg: dict, *, train: bool, cast=None, checkpoint: bool = False,
            keep=None):
    """views [N, V, H, W, 3] normalised -> (raw [N, V, h, w, J], fused or
    None, new running averages)."""
    n, v = views.shape[:2]
    hm, stats = vitpose(w, views.reshape((n * v,) + views.shape[2:]), cfg, train=train,
                        cast=cast, checkpoint=checkpoint, keep=keep)
    raw = hm.reshape((n, v) + hm.shape[1:])
    fused = M.fuse(raw, w["aggre_layer.weight"], cast) if cfg["aggre"] else None
    return raw, fused, stats


def loss(w, batch, cfg: dict, cast=None, checkpoint: bool = False, keep=None):
    """(loss, new running averages, [raw heatmaps, fused heatmaps or
    nothing]) of one batch in training mode: the loss of
    :func:`portbench.reference.train.loss` over this backbone."""
    raw, fused, stats = forward(w, batch["images"], cfg, train=True, cast=cast,
                                checkpoint=checkpoint, keep=keep)
    views = raw.shape[1]
    total = joints_mse(raw, batch["target"], batch["weight"]) * views
    if fused is not None:
        out = M.route(raw, fused, batch["is_h36m"])
        total = total + joints_mse(out, batch["target"], batch["weight"]) * views
        if cfg["consistent_loss"]:
            se = (raw - fused) ** 2
            m = batch["is_h36m"].to(se.dtype).reshape(-1, 1, 1, 1, 1)
            denom = torch.clamp(m.sum() * se[0].numel(), min=1.0)
            total = total + cfg["consistent_loss_weight"] * (se * m).sum() / denom
    return total, stats, [raw] + ([] if fused is None else [fused])


def follow(weights: dict, batches, cfg: dict, drop_seed: int, cast=None,
           checkpoint: bool = False, layer_decay: bool = True):
    """Train ``len(batches)`` steps from ``weights`` (not modified) with
    the drop-path draws of a generator on the weights' device seeded with
    ``drop_seed``. Returns {"losses", "grad1" (the first gradient as
    clipped, as AdamW's first moment takes it), "grad_norm1" (its norm
    before clipping), "maps1", "stats1", "params", "stats"}, as
    :func:`portbench.reference.train.follow`. ``layer_decay`` False: every
    rate unscaled."""
    stat_names = [n for n in weights if n.endswith(("running_mean", "running_var"))]
    params = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()
              if n not in stat_names}
    stats = {n: weights[n].detach().clone() for n in stat_names}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    depth = cfg["depth"]
    scale = {n: cfg["layer_decay"] ** (depth + 1 - layer_of(n, depth)) if layer_decay else 1.0
             for n in params}
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(int(drop_seed))
    images = batches[0]["images"].shape[0] * batches[0]["images"].shape[1]
    out = {"losses": []}
    for step, batch in enumerate(batches, start=1):
        keep = drop_keep(cfg, images, gen)
        value, new_stats, maps = loss({**params, **stats}, batch, cfg, cast, checkpoint, keep)
        names = list(params)
        grads = torch.autograd.grad(value, [params[n] for n in names])
        out["losses"].append(float(value.detach()))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            coef = torch.clamp(cfg["clip_grad_norm"] / (norm + 1e-6), max=1.0)
            grads = [g * coef for g in grads]
        if step == 1:
            out["grad1"] = {n: g.detach().clone() for n, g in zip(names, grads)}
            out["grad_norm1"] = float(norm)
            out["maps1"] = [t.detach().float() for t in maps]
            out["stats1"] = {n: t.detach().clone() for n, t in new_stats.items()}
        with torch.no_grad():
            i = step - 1
            lr = cfg["lr"]
            if i < cfg["warmup_iters"]:
                lr = lr * (1 - (1 - i / cfg["warmup_iters"]) * (1 - cfg["warmup_ratio"]))
            bc1, bc2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
            for n, g in zip(names, grads):
                mu[n].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu[n].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                upd = (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + ADAM_EPS)
                if decays(n, params[n].shape):
                    upd = upd + cfg["weight_decay"] * params[n]
                params[n].sub_(lr * scale[n] * upd)
        stats.update({n: t.detach() for n, t in new_stats.items()})
        del value, grads, maps
    out["params"] = {n: p.detach() for n, p in params.items()}
    out["stats"] = stats
    return out
