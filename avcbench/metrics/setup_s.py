"""setup_s: seconds from the process's start to the window's first
request: imports, the streams' hashes, the program's builds (first run
in a checkout), and one decode of each distinct request, which captures
every graph the traffic uses."""


def read(run):
    return run.setup_s
