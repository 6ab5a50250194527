"""``setup_s``: host seconds from the start of the run to the end of set-up
(imports, opening the card, inputs, the program's own preparation, warm-up;
in a checkout's first run also the kernels' build)."""


def read(run):
    return run.setup_s
