"""argparse command tree with help-priority ordering, like the reference's
``SpecialHelpOrder`` (/root/reference/pykSpider/kSpider2/click_context.py:6-44).

Commands register on a :class:`CommandGroup` with a decorator that
carries their options; :meth:`Cli.main` builds the parser, lists commands
in (help_priority, name) order, parses, and calls the handler with the
:class:`~kspider_tpu.utils.logger.Logger` and the parsed options as
keyword arguments.  Exit codes: 0 on success, 1 from ``Logger.ERROR``,
2 for a usage error.
"""

import argparse
import os
import sys

from kspider_tpu import __version__
from kspider_tpu.utils.logger import Logger

PROG = "kSpider-TPU"


class UsageError(Exception):
    """Bad option values found by a handler; exits 2 like a parse error."""


def opt(*flags, **kwargs):
    """One ``add_argument`` spec: flags or a positional name, then kwargs."""
    return flags, kwargs


def existing_path(value: str) -> str:
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"Path '{value}' does not exist.")
    return value


def int_range(lo: int, hi: int):
    def parse(value: str) -> int:
        v = int(value)
        if not lo <= v <= hi:
            raise argparse.ArgumentTypeError(
                f"{v} is not in the range {lo}<=x<={hi}."
            )
        return v

    parse.__name__ = "integer"
    return parse


def float_range(lo: float, hi: float):
    def parse(value: str) -> float:
        v = float(value)
        if not lo <= v <= hi:
            raise argparse.ArgumentTypeError(
                f"{v} is not in the range {lo}<=x<={hi}."
            )
        return v

    parse.__name__ = "float"
    return parse


class CommandGroup:
    """Commands and sub-groups, listed in help by (priority, name)."""

    def __init__(self, doc: str = ""):
        self.doc = doc
        # (help_priority, name, hidden, handler or CommandGroup, opts)
        self.entries = []

    def command(self, name: str, *opts, help_priority: int = 1,
                hidden: bool = False):
        def decorator(func):
            self.entries.append((help_priority, name, hidden, func, opts))
            return func

        return decorator

    def group(self, name: str, doc: str, help_priority: int = 1):
        sub = CommandGroup(doc)
        self.entries.append((help_priority, name, False, sub, ()))
        return sub

    def _add_to(self, subparsers) -> None:
        for _, name, hidden, entry, opts in sorted(
            self.entries, key=lambda e: (e[0], e[1])
        ):
            doc = entry.doc if isinstance(entry, CommandGroup) else (
                entry.__doc__ or ""
            )
            summary = " ".join(doc.strip().split("\n\n")[0].split())
            # a command added without help= is left out of the listing
            kwargs = {} if hidden else {"help": summary}
            parser = subparsers.add_parser(
                name, description=doc,
                formatter_class=argparse.RawDescriptionHelpFormatter, **kwargs
            )
            if isinstance(entry, CommandGroup):
                sub = parser.add_subparsers(metavar="COMMAND", required=True)
                entry._add_to(sub)
                continue
            for flags, kw in opts:
                parser.add_argument(*flags, **kw)
            parser.set_defaults(_handler=entry)


class Cli(CommandGroup):
    """The root of the command tree."""

    def parser(self) -> argparse.ArgumentParser:
        parser = argparse.ArgumentParser(prog=PROG)
        parser.add_argument(
            "--version", action="version",
            version=f"{PROG}, version {__version__}",
        )
        parser.add_argument("-q", "--quiet", action="store_true")
        sub = parser.add_subparsers(metavar="COMMAND", required=True)
        self._add_to(sub)
        return parser

    def main(self, argv=None) -> None:
        args = vars(self.parser().parse_args(argv))
        handler = args.pop("_handler")
        log = Logger(args.pop("quiet"))
        # every CLI process persists its XLA compiles, so later stages
        # and later runs reuse them
        from kspider_tpu.utils.jaxcache import enable_persistent_cache

        enable_persistent_cache()
        try:
            handler(log, **args)
        except UsageError as e:
            print(f"Error: {e}", file=sys.stderr)
            raise SystemExit(2)


cli = Cli()
