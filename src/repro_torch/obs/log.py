"""Tagged run logging for the launchers.

One :class:`RunLog` per driver replaces the ad-hoc ``print(f"[train]
...")`` lines: quiet mode silences routine output, ``--log-every N``
thins the per-step rows that otherwise spam long runs, and summary
lines (final results, artifact paths) always print.  With default flags
the output text is byte-identical to the old prints.
"""
from __future__ import annotations


class RunLog:
    """``RunLog("train")`` prints ``[train] ...`` lines.

    * :meth:`info` — routine progress; suppressed by ``quiet``.
    * :meth:`step` — per-step rows; suppressed by ``quiet`` and thinned
      to every ``every``-th step (step 0 and multiples always print).
    * :meth:`always` — final summaries and artifact paths; never
      suppressed.
    """

    def __init__(self, tag: str, *, quiet: bool = False, every: int = 1):
        self.tag = tag
        self.quiet = bool(quiet)
        self.every = max(1, int(every))

    def _emit(self, msg: str):
        print(f"[{self.tag}] {msg}")

    def info(self, msg: str):
        if not self.quiet:
            self._emit(msg)

    def step(self, i: int, msg: str):
        if not self.quiet and i % self.every == 0:
            self._emit(msg)

    def always(self, msg: str):
        self._emit(msg)


def add_log_args(parser):
    """Attach the shared ``--quiet`` / ``--log-every`` flags."""
    parser.add_argument("--quiet", action="store_true",
                        help="suppress routine progress output")
    parser.add_argument("--log-every", type=int, default=1, metavar="N",
                        help="print every N-th per-step row (default 1)")
    return parser


def from_args(tag: str, args) -> RunLog:
    return RunLog(tag, quiet=getattr(args, "quiet", False),
                  every=getattr(args, "log_every", 1))
