"""setup_s: process start to the window's start: imports, the kernels'
builds where a library is stale, the scene's assembly and upload, the
warm-up step."""


def read(run):
    return run.setup_s
