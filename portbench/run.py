"""Run one cell of the benchmark and print its result line.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device, with --trace 1
also breakdown, and last the numbers compared with their limits, which
also end standard error). Without enough cards, or if JAX or the JAX
package was loaded, it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()       # set-up is counted from the interpreter's
                               # first statement, imports included

import sys  # noqa: E402

from portbench import harness  # noqa: E402

if __name__ == "__main__":
  sys.exit(harness.main(sys.argv[1:], T0))
