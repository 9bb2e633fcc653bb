"""Terminal-width-aware help formatting.

The analog of the reference's pkg/cmd/help/doc.go (Doc/FitTerminal):
reflow long description text to the current terminal width so CLI help
stays readable in narrow terminals.
"""

from __future__ import annotations

import argparse
import shutil
import textwrap


def fit_terminal(text: str, width: int | None = None) -> str:
    """Reflow paragraphs to the terminal width (reference: FitTerminal)."""
    if width is None:
        width = min(shutil.get_terminal_size((80, 24)).columns, 100)
    out: list[str] = []
    for para in text.strip().split("\n\n"):
        # preserve indented/code blocks verbatim
        if para.startswith("  "):
            out.append(para)
        else:
            out.append(textwrap.fill(" ".join(para.split()), width))
    return "\n\n".join(out)


class DocFormatter(argparse.RawDescriptionHelpFormatter):
    """argparse formatter that width-fits the description."""


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    return argparse.ArgumentParser(
        prog=prog, description=fit_terminal(doc), formatter_class=DocFormatter)
