"""What the port's run entry points share (`bench`, `bench_suite`,
`tools.*`, `examples.*`): the device they run on, the barrier that ends a
timed region, and the log on stderr.

Every entry point runs on the card unless its caller passes
`--device cpu`. Where there is no card and the caller did not ask for the
CPU, it exits non-zero with a message: nothing falls back to the CPU, or
to smaller sizes, on its own.
"""

from __future__ import annotations

import sys

import torch

DEVICES = ("cuda", "cpu")


def add_device_argument(parser) -> None:
    parser.add_argument(
        "--device", choices=DEVICES, default="cuda",
        help="where to run (default: the card; cpu only when asked)")


def entry_device(choice: str) -> torch.device:
    """The device named on the command line; exits with a message when it
    is "cuda" and there is no card."""
    if choice == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this entry point runs on the card; "
                         "pass --device cpu to run it on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def barrier(dev: torch.device) -> None:
    """Wait for the work queued on `dev`: the end of every timed region."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
