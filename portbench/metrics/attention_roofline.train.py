"""attention_roofline.train: the share of their roofline that a ViTPose
step's attention kernels reach, in %: the bound of the work
(portbench/counts_vit.py:attention_bound_ms, forward and backward, from the
shapes) over the device time of the attention's forward and backward
kernels, with the helpers a backward launches beside its main kernel,
found by name in the traced sub-window. Nothing is read unless the
forward's and the backward's main kernels each launched once a block a
step."""

from portbench import counts_vit

# the kernels of F.scaled_dot_product_attention's backends, by name: cuDNN's
# (what PyTorch picked on the H100), FlashAttention-2, the memory-efficient ones
FORWARD = ("sdpa_sm90_flash_fprop", "flash_fwd", "fmha_cutlassF")
BACKWARD = ("sdpa_sm90_flash_bprop", "flash_bwd_dq_dk_dv", "fmha_cutlassB")
# the backward's helpers: dot(dO, O) before it and dQ's conversion after it
HELPERS = ("cudnn::fusion::compute_dot_do_o", "cudnn::fusion::convert_dq_to_16bits",
           "flash_bwd_dot_do_o", "flash_bwd_convert_dq", "flash_bwd_clear_dq")


def read(rec):
    tr, cfg = rec.trace, rec.cfg
    if rec.kind != "train" or tr is None or not tr.iterations or "embed_dim" not in cfg:
        return None
    kinds = (FORWARD, BACKWARD, HELPERS)
    ops = [[(a, b) for n, a, b in tr.ops if any(k in n for k in names)] for names in kinds]
    want = cfg["depth"] * tr.iterations
    if len(ops[0]) != want or len(ops[1]) != want:
        return None
    us = sum(b - a for part in ops for a, b in part)
    bound = counts_vit.attention_bound_ms(cfg, rec.cell["groups"] * rec.cell["views"])
    return 100.0 * (bound["forward"] + bound["backward"]) * tr.iterations * 1e3 / us
