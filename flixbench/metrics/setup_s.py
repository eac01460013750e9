"""Host seconds from the process's start to the window's: imports, the
kernel library's load (and its build, in a checkout's first run), the
index's build on the card and the warm-up steps."""


def read(run):
    return run.setup_s
