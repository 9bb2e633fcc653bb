"""compat — check two CRD schemas for compatibility, optionally print LCD.

The analog of the reference's cmd/compat/main.go:19-76: load two CRD YAML
files, run the structural-schema compatibility check, and exit non-zero on
incompatibility; --lcd prints the lowest-common-denominator schema.
"""

from __future__ import annotations

import sys

import yaml

from ..schemacompat import ensure_structural_schema_compatibility
from .help import parser

DOC = """Compare the schemas of two CustomResourceDefinition YAML files.
Exits 0 when the new CRD is compatible with the existing one; prints the
incompatibilities and exits 1 otherwise. With --lcd, prints the lowest
common denominator schema (narrowing the existing schema where needed)."""


def _schema_of(crd: dict) -> dict:
    """First served version's openAPIV3Schema."""
    for v in crd.get("spec", {}).get("versions", []):
        if not v.get("served", True):
            continue
        schema = (v.get("schema") or {}).get("openAPIV3Schema")
        if schema:
            return schema
    return crd.get("spec", {}).get("validation", {}).get("openAPIV3Schema", {})


def build_parser():
    p = parser("compat", DOC)
    p.add_argument("existing", help="existing CRD YAML file")
    p.add_argument("new", help="new CRD YAML file")
    p.add_argument("--lcd", action="store_true",
                   help="narrow to and print the LCD schema "
                        "(reference: --lcd flag)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    with open(args.existing, encoding="utf-8") as f:
        existing = yaml.safe_load(f)
    with open(args.new, encoding="utf-8") as f:
        new = yaml.safe_load(f)
    lcd, errs = ensure_structural_schema_compatibility(
        _schema_of(existing), _schema_of(new), narrow_existing=args.lcd)
    if errs and not args.lcd:
        for e in errs:
            print(e, file=sys.stderr)
        return 1
    if args.lcd:
        yaml.safe_dump(lcd, sys.stdout, sort_keys=False)
    else:
        print("compatible")
    return 0


if __name__ == "__main__":
    sys.exit(main())
