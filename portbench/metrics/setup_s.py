"""setup_s: seconds from the interpreter's first statement to the window's
start: imports, the card's context, the scene and weights from the seed,
kernel builds and the warm-up of every shape the window uses."""


def read(rec):
  return rec.get("setup_s")
