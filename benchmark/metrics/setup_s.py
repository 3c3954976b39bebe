"""setup_s: from the start of the process to the start of the window:
the data made and compressed, the program loaded (and, in a first run,
built) and one warm call a file."""


def read(w):
    return w.setup_s
