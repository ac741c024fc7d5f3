"""Device ms a request in its frame copy in and its labels copy out
(the H2D and D2H copies around the captured replay)."""


def read(w, ctx):
    return w.per_unit_ms("copy_h2d", "copy_d2h")
