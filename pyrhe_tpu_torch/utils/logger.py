"""Run logging: console echo + end-of-run report file.

The saved report file doubles as the machine-readable result (the
integration tests regex-parse it), so its record format is a hard output
contract: `_log` lines are written verbatim, in order, one per call.
Behavioral contract only — this implementation rides stdlib `logging`
with a buffering handler rather than a replayed message list.

`_debug` messages go to stdout only (never into the report file);
`suppress=True` silences the console but still buffers report lines.
"""
from __future__ import annotations

import itertools
import logging


class _ReportBuffer(logging.Handler):
    """Accumulates formatted records for the final report file."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.lines: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append(record.getMessage())


_uniq = itertools.count()


class Logger:
    def __init__(self, output_file=None, suppress=False, debug_mode=True):
        self.output_file = output_file
        self.suppress = suppress
        self.debug_mode = debug_mode
        # a private logger per instance: parallel runs (e.g. the phenotype
        # sweep driver) must not interleave report buffers
        self._logger = logging.getLogger(f"pyrhe_tpu_torch.run{next(_uniq)}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        self._buffer = _ReportBuffer()
        self._logger.addHandler(self._buffer)
        if not suppress:
            console = logging.StreamHandler()
            console.setFormatter(logging.Formatter("%(message)s"))
            self._logger.addHandler(console)

    @property
    def msgs(self):
        """Report lines buffered so far (newline-terminated)."""
        return [line + "\n" for line in self._buffer.lines]

    def _debug(self, msg) -> None:
        """Console-only diagnostic (kept out of the report file)."""
        if self.debug_mode:
            print(msg)

    def _log(self, *args) -> None:
        """Record a report line (and echo it unless suppressed)."""
        self._logger.info(" ".join(str(a) for a in args))

    def _save_log(self) -> None:
        if self.output_file is None:
            return
        with open(self.output_file, "w") as fd:
            for line in self._buffer.lines:
                fd.write(line + "\n")
