"""Set-up seconds: from the start of the process through imports, loading
the built kernels (building them in a fresh checkout), making the inputs
and the warm step, to the card's last op of the warm step (host clock)."""


def read(run):
    return run.setup_s
