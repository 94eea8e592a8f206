"""In-process runner for the argparse CLI, for tests."""

import contextlib
import io
from dataclasses import dataclass


@dataclass
class Result:
    exit_code: int
    output: str


class CliRunner:
    """Run ``cli.main(args)`` in this process, capturing stdout and stderr
    together and turning ``SystemExit`` into an exit code."""

    def invoke(self, cli, args) -> Result:
        buf = io.StringIO()
        code = 0
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            try:
                cli.main([str(a) for a in args])
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 1
        return Result(code, buf.getvalue())
