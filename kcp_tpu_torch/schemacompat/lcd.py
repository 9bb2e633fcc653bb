"""Structural-schema compatibility + Lowest-Common-Denominator construction.

Behavioral port of the reference's negotiation math (pkg/schemacompat/
schemacompat.go:34-417) over plain JSON-schema dicts (openAPIV3Schema as
stored in CommonAPIResourceSpec). The contract:

    ensure_structural_schema_compatibility(existing, new, narrow)
        -> (lcd, errors)

checks that *existing* is a sub-schema of *new* (every document valid
under existing is valid under new, i.e. new is backward-compatible).
With ``narrow=True`` incompatibilities are resolved by narrowing: the
returned LCD accepts exactly the documents both schemas accept (where
computable), and only truly unsupported/unreconcilable constructs error.

Like the reference, unsupported JSON-Schema constructs fail closed: a
construct whose comparison is not implemented reports an incompatibility
rather than silently passing (schemacompat.go:23-26).

The engine stays host-side (irregular tree recursion); the batch-scale
path is hashing schemas to buckets on device (ops/schemahash.py) so only
distinct schemas walk this code.

One deliberate deviation: the reference's checks for ``anyOf``/``oneOf``
on strings/booleans/arrays accidentally inspect ``allOf`` (schemacompat.go
:208-209 et al.); here each construct is checked for real.
"""

from __future__ import annotations

import copy
from typing import Any

INT_OR_STRING = "x-kubernetes-int-or-string"
PRESERVE_UNKNOWN = "x-kubernetes-preserve-unknown-fields"
EMBEDDED = "x-kubernetes-embedded-resource"


class CompatError(Exception):
    """Aggregated incompatibility report."""

    def __init__(self, errors: list[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


def ensure_structural_schema_compatibility(
    existing: dict, new: dict, narrow_existing: bool = False, fld_path: str = "schema.openAPISchema"
) -> tuple[dict, list[str]]:
    """Returns (lcd, errors). ``lcd`` is meaningful when errors is empty
    (or when narrowing resolved them)."""
    lcd = copy.deepcopy(existing)
    errors: list[str] = []
    _lcd_for_structural(fld_path, existing, new, lcd, narrow_existing, errors)
    return lcd, errors


# ---------------------------------------------------------------- helpers

def _typ(s: dict | None) -> str:
    return (s or {}).get("type", "")


def _err(errors: list[str], path: str, msg: str) -> None:
    errors.append(f"{path}: {msg}")


def _check_same_type(path: str, existing: dict, new: dict, errors: list[str]) -> bool:
    if _typ(new) != _typ(existing):
        _err(errors, f"{path}.type",
             f'The type changed (was "{_typ(existing)}", now "{_typ(new)}")')
        return False
    return True


def _check_unsupported(path: str, existing: Any, new: Any, name: str, typename: str,
                       errors: list[str]) -> None:
    """Fail closed on constructs whose comparison is not implemented.

    Presence-based, not truthiness-based: ``maximum: 0`` or ``pattern: ""``
    are real constraints and must fail closed exactly like any other value
    (the reference checks nil pointers, not zero values).
    """
    if existing is not None or new is not None:
        _err(errors, path,
             f'The "{name}" JSON Schema construct is not supported by the '
             f'Schema negotiation for type "{typename}"')


def _check_numeric_validation(path: str, existing: dict, new: dict, typename: str,
                              errors: list[str]) -> None:
    for name in ("not", "allOf", "anyOf", "oneOf", "enum"):
        _check_unsupported(path, existing.get(name), new.get(name), name, typename, errors)
    if (existing.get("maximum") != new.get("maximum")
            or existing.get("minimum") != new.get("minimum")
            or bool(existing.get("exclusiveMaximum")) != bool(new.get("exclusiveMaximum"))
            or bool(existing.get("exclusiveMinimum")) != bool(new.get("exclusiveMinimum"))):
        _check_unsupported(path, existing.get("maximum"), new.get("maximum"),
                           "maximum", typename, errors)
        _check_unsupported(path, existing.get("minimum"), new.get("minimum"),
                           "minimum", typename, errors)
    if existing.get("multipleOf") != new.get("multipleOf"):
        _check_unsupported(path, existing.get("multipleOf"), new.get("multipleOf"),
                           "multipleOf", typename, errors)


# ------------------------------------------------------------ dispatcher

def _lcd_for_structural(path: str, existing: dict | None, new: dict | None, lcd: dict,
                        narrow: bool, errors: list[str]) -> None:
    if new is None:
        _err(errors, path, "new schema doesn't allow anything")
        return
    existing = existing or {}
    if bool(existing.get(PRESERVE_UNKNOWN)) != bool(new.get(PRESERVE_UNKNOWN)):
        _err(errors, f"{path}.{PRESERVE_UNKNOWN}",
             f"{PRESERVE_UNKNOWN} value changed (was {bool(existing.get(PRESERVE_UNKNOWN))}, "
             f"now {bool(new.get(PRESERVE_UNKNOWN))})")
        return

    t = _typ(existing)
    if t == "number":
        _lcd_for_number(path, existing, new, lcd, narrow, errors)
    elif t == "integer":
        _lcd_for_integer(path, existing, new, lcd, narrow, errors)
    elif t == "string":
        _lcd_for_string(path, existing, new, lcd, narrow, errors)
    elif t == "boolean":
        _lcd_for_boolean(path, existing, new, lcd, narrow, errors)
    elif t == "array":
        _lcd_for_array(path, existing, new, lcd, narrow, errors)
    elif t == "object":
        _lcd_for_object(path, existing, new, lcd, narrow, errors)
    elif t == "":
        if existing.get(INT_OR_STRING):
            _lcd_for_int_or_string(path, existing, new, lcd, narrow, errors)
        elif existing.get(PRESERVE_UNKNOWN):
            _check_same_type(path, existing, new, errors)
        elif existing.get(EMBEDDED):
            # Deliberate deviation: the reference's type dispatch
            # (schemacompat.go:144-165) has no case for a typeless
            # arbitrary node carrying only x-kubernetes-embedded-resource
            # — yet its own puller emits exactly that shape
            # (VisitArbitrary, discovery.go:325-335), so an imported
            # schema with an arbitrary subtree would fail LCD against an
            # identical copy of itself. Treat it like preserve-unknown:
            # compatible iff the new node is the same arbitrary shape.
            if bool(existing.get(EMBEDDED)) != bool(new.get(EMBEDDED)):
                _err(errors, f"{path}.{EMBEDDED}",
                     f"{EMBEDDED} value changed (was "
                     f"{bool(existing.get(EMBEDDED))}, "
                     f"now {bool(new.get(EMBEDDED))})")
            else:
                _check_same_type(path, existing, new, errors)
        else:
            _err(errors, f"{path}.type", f'Invalid type: "{t}"')
    else:
        _err(errors, f"{path}.type", f'Invalid type: "{t}"')


# ----------------------------------------------------------- per-type lcd

def _lcd_for_number(path: str, existing: dict, new: dict, lcd: dict,
                    narrow: bool, errors: list[str]) -> None:
    if _typ(new) == "integer":
        # new is a subset of existing: only acceptable when narrowing
        if not narrow:
            _check_same_type(path, existing, new, errors)
            return
        lcd["type"] = "integer"
        _check_numeric_validation(path, existing, new, "integer", errors)
        return
    if not _check_same_type(path, existing, new, errors):
        return
    _check_numeric_validation(path, existing, new, "numbers", errors)


def _lcd_for_integer(path: str, existing: dict, new: dict, lcd: dict,
                     narrow: bool, errors: list[str]) -> None:
    if _typ(new) != "number":
        # "number" widens integer: fine, LCD keeps integer
        if not _check_same_type(path, existing, new, errors):
            return
    _check_numeric_validation(path, existing, new, "integer", errors)


def _lcd_for_string_validation(path: str, existing: dict, new: dict, lcd: dict,
                               narrow: bool, errors: list[str]) -> None:
    for name in ("allOf", "anyOf", "oneOf"):
        _check_unsupported(path, existing.get(name), new.get(name), name, "string", errors)
    if (existing.get("maxLength") != new.get("maxLength")
            or existing.get("minLength") != new.get("minLength")):
        _check_unsupported(path, existing.get("maxLength"), new.get("maxLength"),
                           "maxLength", "string", errors)
        _check_unsupported(path, existing.get("minLength"), new.get("minLength"),
                           "minLength", "string", errors)
    if existing.get("pattern") != new.get("pattern"):
        _check_unsupported(path, existing.get("pattern"), new.get("pattern"),
                           "pattern", "string", errors)

    def enum_set(schema: dict) -> set[str]:
        vals = set()
        for v in schema.get("enum") or []:
            if not isinstance(v, str):
                _err(errors, f"{path}.enum",
                     "enum value should be a 'string' for Json type 'string'")
                continue
            vals.add(v)
        return vals

    existing_enum = enum_set(existing)
    new_enum = enum_set(new)
    if not new_enum.issuperset(existing_enum):
        if not narrow:
            removed = sorted(new_enum - existing_enum)
            _err(errors, f"{path}.enum",
                 f"enum value has been changed in an incompatible way ({removed})")
        inter = sorted(existing_enum & new_enum)
        if inter:
            lcd["enum"] = inter
        else:
            lcd.pop("enum", None)
    if existing.get("format") != new.get("format"):
        _err(errors, f"{path}.format", "format value has been changed in an incompatible way")


def _lcd_for_string(path: str, existing: dict, new: dict, lcd: dict,
                    narrow: bool, errors: list[str]) -> None:
    _check_same_type(path, existing, new, errors)
    _lcd_for_string_validation(path, existing, new, lcd, narrow, errors)


def _lcd_for_boolean(path: str, existing: dict, new: dict, lcd: dict,
                     narrow: bool, errors: list[str]) -> None:
    _check_same_type(path, existing, new, errors)
    for name in ("allOf", "anyOf", "oneOf", "enum"):
        _check_unsupported(path, existing.get(name), new.get(name), name, "boolean", errors)


def _lcd_for_array(path: str, existing: dict, new: dict, lcd: dict,
                   narrow: bool, errors: list[str]) -> None:
    _check_same_type(path, existing, new, errors)
    for name in ("allOf", "anyOf", "oneOf", "enum"):
        _check_unsupported(path, existing.get(name), new.get(name), name, "array", errors)
    if (existing.get("maxItems") != new.get("maxItems")
            or existing.get("minItems") != new.get("minItems")):
        _check_unsupported(path, existing.get("maxItems"), new.get("maxItems"),
                           "maxItems", "array", errors)
        _check_unsupported(path, existing.get("minItems"), new.get("minItems"),
                           "minItems", "array", errors)
    if not existing.get("uniqueItems") and new.get("uniqueItems"):
        if not narrow:
            _err(errors, f"{path}.uniqueItems",
                 "uniqueItems value has been changed in an incompatible way")
        else:
            lcd["uniqueItems"] = True
    if "items" in existing or "items" in new:
        lcd_items = lcd.setdefault("items", copy.deepcopy(existing.get("items") or {}))
        _lcd_for_structural(f"{path}.items", existing.get("items"), new.get("items"),
                            lcd_items, narrow, errors)
    if existing.get("x-kubernetes-list-type") != new.get("x-kubernetes-list-type"):
        _err(errors, f"{path}.x-kubernetes-list-type",
             "x-kubernetes-list-type value has been changed in an incompatible way")
    if set(existing.get("x-kubernetes-list-map-keys") or ()) != set(
            new.get("x-kubernetes-list-map-keys") or ()):
        _err(errors, f"{path}.x-kubernetes-list-map-keys",
             "x-kubernetes-list-map-keys value has been changed in an incompatible way")


def _lcd_for_object(path: str, existing: dict, new: dict, lcd: dict,
                    narrow: bool, errors: list[str]) -> None:
    _check_same_type(path, existing, new, errors)
    if existing.get("x-kubernetes-map-type") != new.get("x-kubernetes-map-type"):
        _err(errors, f"{path}.x-kubernetes-map-type",
             "x-kubernetes-map-type value has been changed in an incompatible way")

    # structural schemas: properties and additionalProperties are mutually
    # exclusive (schemacompat.go:323-324)
    existing_props: dict = existing.get("properties") or {}
    new_props: dict = new.get("properties") or {}
    new_ap = new.get("additionalProperties")
    existing_ap = existing.get("additionalProperties")

    if existing_props:
        if new_props:
            kept = set(existing_props)
            if not set(new_props).issuperset(kept):
                if not narrow:
                    removed = sorted(set(existing_props) - set(new_props))
                    _err(errors, f"{path}.properties",
                         f"properties have been removed in an incompatible way ({removed})")
                kept = set(existing_props) & set(new_props)
            for key in sorted(kept):
                _lcd_for_structural(f"{path}.properties[{key}]",
                                    existing_props[key], new_props[key],
                                    lcd["properties"][key], narrow, errors)
            for removed_key in set(existing_props) - kept:
                del lcd["properties"][removed_key]
        elif isinstance(new_ap, dict) and new_ap:
            for key in sorted(existing_props):
                _lcd_for_structural(f"{path}.properties[{key}]",
                                    existing_props[key], new_ap,
                                    lcd["properties"][key], narrow, errors)
        elif new_ap is True:
            pass  # new allows anything: existing stays the LCD
        else:
            _err(errors, f"{path}.properties",
                 f"properties value has been completely cleared in an incompatible way "
                 f"({sorted(existing_props)})")
    elif existing_ap is not None:
        if isinstance(existing_ap, dict) and existing_ap:
            if isinstance(new_ap, dict) and new_ap:
                _lcd_for_structural(f"{path}.additionalProperties", existing_ap, new_ap,
                                    lcd["additionalProperties"], narrow, errors)
            elif new_ap is True:
                pass  # superset: keep existing
            else:
                _err(errors, f"{path}.additionalProperties",
                     "additionalProperties value has been changed in an incompatible way")
        elif existing_ap is True:
            if new_ap is not True:
                if not narrow:
                    _err(errors, f"{path}.additionalProperties",
                         "additionalProperties value has been changed in an incompatible way")
                lcd["additionalProperties"] = copy.deepcopy(new_ap)

    for name in ("allOf", "anyOf", "oneOf", "enum"):
        _check_unsupported(path, existing.get(name), new.get(name), name, "object", errors)


def _lcd_for_int_or_string(path: str, existing: dict, new: dict, lcd: dict,
                           narrow: bool, errors: list[str]) -> None:
    _check_same_type(path, existing, new, errors)
    if not new.get(INT_OR_STRING):
        _err(errors, f"{path}.{INT_OR_STRING}",
             f"{INT_OR_STRING} value has been changed in an incompatible way")
    # int-or-string carries a fixed anyOf; compare it separately and hide it
    # from the string/integer validation passes (schemacompat.go:394-411)
    if existing.get("anyOf") != new.get("anyOf"):
        _err(errors, f"{path}.anyOf", "anyOf value has been changed in an incompatible way")
    ex = {k: v for k, v in existing.items() if k != "anyOf"}
    nw = {k: v for k, v in new.items() if k != "anyOf"}
    _lcd_for_string_validation(path, ex, nw, lcd, narrow, errors)
    _check_numeric_validation(path, ex, nw, "integer", errors)
