"""Set-up: from the interpreter's start to the window's, with the kernel
build, the frames made on the card and the warm-up episode."""
UNIT = "s"
MOVES = None


def read(rec):
    return rec.setup_s
