"""scene.compile_s: host clock around the port's assembly of the
description (SceneBuilder.build or scene.assemble)."""


def read(run):
    return run.compile_s
