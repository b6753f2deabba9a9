"""setup_s: seconds from the start of the process to the first timed call
(imports, CUDA context, the kernels' libraries, the data made on the card,
the cell's own warm step)."""


def read(run):
    return run.setup_s
