"""setup_s: process start until the first timed frame or iteration
(imports, CUDA, kernel builds or loads, the scene, its build, binding,
warm-up), host clock."""


def read(run):
    return getattr(run, "setup_s", None)
