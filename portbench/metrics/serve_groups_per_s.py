"""serve_groups_per_s: four-view groups whose 3D poses reached the host in
the window, over the window's wall seconds (host clock; the window ends
when its last request does)."""


def read(rec):
    if rec.kind != "serve" or not rec.window_s > 0:
        return None
    return rec.groups / rec.window_s
