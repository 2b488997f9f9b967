"""Run one cell of the benchmark once:

    python3 -m gpbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, as JSON; the numbers the check compared, each with its limit, are
the last lines of standard error.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before torch is imported

import sys  # noqa: E402


def main() -> None:
    if not __package__:  # run as a file: make the checkout's root importable
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from gpbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))


if __name__ == "__main__":
    main()
