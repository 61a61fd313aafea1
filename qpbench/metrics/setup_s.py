"""setup_s: seconds from the process's start to the window's start
(imports, the program's CUDA libraries where they are not built yet, the
model from the seed's draws, captures, warm-up)."""


def read(rec, config):
    return rec.setup_s
