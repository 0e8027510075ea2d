"""Host seconds from the assets handed over to a Scene ready on the card
(flatten, texture pool, upload)."""

UNIT, LAYER, MOVES = "s", "scene", "setup_s"


def read(run):
    return run.scene_build_s
