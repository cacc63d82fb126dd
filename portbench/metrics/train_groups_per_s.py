"""train_groups_per_s: four-view groups stepped in the window over the
window's wall seconds (host clock; the window ends in a synchronize, so
every step it launched has finished)."""


def read(rec):
    if rec.kind != "train" or not rec.window_s > 0:
        return None
    return rec.groups / rec.window_s
