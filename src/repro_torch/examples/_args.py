"""The options every example takes."""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` (the card unless
    told otherwise)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the example computes: cuda (default) or cpu")
    return ap
