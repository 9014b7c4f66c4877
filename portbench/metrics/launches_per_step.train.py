"""launches_per_step.train: kernel launches a step (runtime calls with at
least one device operation) inside the program's whole ``cgt.train.step``
ranges of the traced stretch, over the count of those ranges
(``program_spans.launches_per_root``). Also prints the table of the
stretch by program span on standard error: calls, launches, their device
ms, the idle ms whose gap closed on one of them, and device-to-host copies
(each one a host sync). Importing this file turns the program's recorder
on."""

from portbench import program_spans

program_spans.turn_on()


def read(rec):
  if rec.get("kind") != "train":
    return None
  ranges = program_spans.program_ranges(rec)
  program_spans.print_table(rec, ranges)
  return program_spans.launches_per_root(rec, ranges, "train.step")
