"""Set-up: from the start of the run's script to the first timed call
(imports, CUDA start, the program's libraries built or loaded, the corpus
made from the seed, the warm-up pass)."""


def read(record):
    return record["setup_s"]
