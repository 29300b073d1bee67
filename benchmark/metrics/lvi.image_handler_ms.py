"""lvi.image_handler_ms: mean ms of the fused system's ``image`` handler
(its ``StageTimer`` rows) over the window's handled events."""


def read(ctx):
    rows = ctx["win"].stages.get("image")
    return sum(rows) / len(rows) if rows else None
