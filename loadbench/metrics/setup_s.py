"""Seconds from the process's start to the window's opening: imports, the
index made and handed to the program, the program's read of the graph file,
the shapes warmed, the users started and warm. The making and writing of the
graph file, which a deployment already has, are left out."""


def read(run):
    return run.setup_s
