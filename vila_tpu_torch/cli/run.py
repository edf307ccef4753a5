"""`vila-torch-run`, as `vila_tpu/cli/run.py`: run a command and retry it.

    vila-torch-run [--max-retries 3] [--timeout SECONDS] -- <command> [args]

Capability parity: llava/cli/run.py:30-135. Exit 0 returns 0; exit 124 (a
timeout, or the port's `Trainer` stopping on preemption after its last
checkpoint) retries without limit; any other code retries up to
`--max-retries` times and is then returned. SLURM's srun is a plain
subprocess here; the retry semantics are the reference's.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

TIMEOUT_EXIT_CODE = 124


def run_with_retries(cmd, max_retries: int = 3, timeout: float = None) -> int:
    attempt = 0
    while True:
        attempt += 1
        try:
            code = subprocess.run(cmd, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            code = TIMEOUT_EXIT_CODE
        if code == 0:
            return 0
        if code == TIMEOUT_EXIT_CODE:
            # timeouts retry forever (cli/run.py:117-131): the job made
            # progress and saved a checkpoint before the limit
            print(f"[vila-torch-run] timeout on attempt {attempt}; retrying...",
                  file=sys.stderr)
            continue
        if attempt > max_retries:
            print(f"[vila-torch-run] failed after {max_retries} retries", file=sys.stderr)
            return code
        print(f"[vila-torch-run] exit {code}; retry {attempt}/{max_retries}", file=sys.stderr)
        time.sleep(min(10 * attempt, 60))


def main(argv=None):
    parser = argparse.ArgumentParser("vila-torch-run")
    parser.add_argument("--max-retries", type=int, default=3)
    parser.add_argument("--timeout", type=float, default=None)
    parser.add_argument("cmd", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    sys.exit(run_with_retries(cmd, args.max_retries, args.timeout))


if __name__ == "__main__":
    main()
