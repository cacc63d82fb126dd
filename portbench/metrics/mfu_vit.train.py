"""mfu_vit.train: a ViTPose cell's model FLOPs a step (the patch embedding,
the blocks, the head and the fusion's products, two a multiply-accumulate,
three times for the forward and backward, from the configuration's shapes:
portbench/counts_vit.py) times the window's steps, over the window's
seconds and the chip's 989 TFLOP/s bf16 peak."""

from portbench import counts, counts_vit


def read(rec):
    if rec.kind != "train" or "embed_dim" not in rec.cfg or not rec.window_s > 0 or not rec.groups:
        return None
    flops = counts_vit.train_step_flops(rec.cfg, rec.cell["groups"], rec.cell["views"])
    steps = rec.groups / rec.cell["groups"]
    return 100.0 * flops * steps / rec.window_s / counts.PEAK_BF16_FLOPS
