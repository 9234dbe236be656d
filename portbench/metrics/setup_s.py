"""setup_s: seconds from the start of the process to the start of the
window: imports, the kernel library's load (its build in a fresh checkout),
the weights made on the card, the scene pools, the cell's warm-up and any
graph capture."""


def read(record):
    return record.setup_s
