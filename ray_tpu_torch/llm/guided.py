"""Guided (constrained) decoding: JSON mode and json-schema mode (the
port's own copy of ray_tpu/llm/guided.py, host code in numpy).

Enforcement is native: an incremental character-level JSON automaton
(with a bracket stack) classifies decode states, and per-state vocab
masks — precomputed once per tokenizer — zero out every token that
could make the output non-JSON. The engine applies the mask to the
logits before sampling, so ANY sampling configuration (greedy, nucleus,
penalties) stays inside the constraint.

Design notes:
- The mask is computed host-side from a per-state cache (numpy bool[V])
  and applied in the host sampling path the engine already uses for
  guided requests; nothing about the device step changes.
- Tokens containing closing brackets/braces depend on the live stack,
  so they are classified per-step against the actual parser stack —
  that set is tiny (a few hundred of 50k tokens).
- json_schema mode constrains the GRAMMAR during decode and validates
  the finished object against the schema, additionally steering the
  top-level structure to an object when the schema demands it.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Incremental JSON automaton.
#
# States are (mode, stack) where mode captures the local lexical state
# and stack is the open-container nesting ('{' / '['). The MASKABLE
# abstraction: which characters may come next depends only on `mode`
# plus whether the stack top is an object/array — a small closed set of
# "state classes" that vocab masks can be precomputed for.

V_START = "value_start"       # expecting a value
IN_STR = "in_string"          # inside a string value/key
IN_STR_ESC = "in_string_esc"  # after a backslash inside a string
IN_STR_U = "in_string_u"      # inside a \uXXXX escape (value string)
KEY_U = "key_string_u"        # inside a \uXXXX escape (key string)
IN_NUM = "in_number"          # inside a number
IN_LIT = "in_literal"         # inside true/false/null
KEY_START = "key_start"       # inside object, expecting '"' (or '}')
KEY_STR = "key_string"        # inside a key string
KEY_ESC = "key_string_esc"
AFTER_KEY = "after_key"       # expecting ':'
AFTER_VAL = "after_value"     # expecting ',' or close
DONE = "done"                 # top-level value complete

_WS = " \t\n\r"
_DIGITS = "0123456789"
_LITERALS = ("true", "false", "null")


class JsonState:
    """One decode slot's incremental JSON parse state."""

    __slots__ = ("mode", "stack", "lit_progress", "num_text", "text_len",
                 "hex_left")

    def __init__(self):
        self.mode = V_START
        self.stack: list[str] = []
        self.lit_progress = ""   # matched prefix of a literal
        self.num_text = ""       # current number token text
        self.text_len = 0
        self.hex_left = 0        # remaining digits of a \uXXXX escape

    def clone(self) -> "JsonState":
        s = JsonState.__new__(JsonState)
        s.mode = self.mode
        s.stack = list(self.stack)
        s.lit_progress = self.lit_progress
        s.num_text = self.num_text
        s.text_len = self.text_len
        s.hex_left = self.hex_left
        return s

    # -- the character automaton ------------------------------------------

    def feed(self, ch: str) -> bool:
        """Advance by one character. Returns False on violation."""
        m = self.mode
        if m == DONE:
            return ch in _WS
        if m == IN_STR or m == KEY_STR:
            if ch == "\\":
                self.mode = IN_STR_ESC if m == IN_STR else KEY_ESC
                return True
            if ch == '"':
                if m == KEY_STR:
                    self.mode = AFTER_KEY
                else:
                    self._value_done()
                return True
            return ch >= " "  # control chars are invalid raw
        if m == IN_STR_ESC or m == KEY_ESC:
            back = IN_STR if m == IN_STR_ESC else KEY_STR
            if ch == "u":
                self.mode = IN_STR_U if m == IN_STR_ESC else KEY_U
                self.hex_left = 4
                return True
            self.mode = back
            return ch in '"\\/bfnrt'
        if m == IN_STR_U or m == KEY_U:
            if ch not in "0123456789abcdefABCDEF":
                return False
            self.hex_left -= 1
            if self.hex_left == 0:
                self.mode = IN_STR if m == IN_STR_U else KEY_STR
            return True
        if m == IN_NUM:
            if ch in _DIGITS or ch in ".eE+-":
                nt = self.num_text + ch
                if not _plausible_number(nt):
                    return False
                self.num_text = nt
                return True
            # number ended; re-feed terminator in the after-value state.
            # Only a complete number may end ("1e", "-" or "1." may not;
            # ray_tpu's automaton lets them, and json.loads then fails).
            if not _valid_number(self.num_text):
                return False
            self._value_done()
            self.num_text = ""
            return self.feed(ch)
        if m == IN_LIT:
            want = next((w for w in _LITERALS
                         if w.startswith(self.lit_progress)), None)
            if want is None:
                return False
            nxt = self.lit_progress + ch
            matched = next((w for w in _LITERALS if w.startswith(nxt)), None)
            if matched is None:
                return False
            self.lit_progress = nxt
            if nxt in _LITERALS:
                self.lit_progress = ""
                self._value_done()
            return True
        if m == V_START:
            if ch in _WS:
                return True
            if ch == '"':
                self.mode = IN_STR
                return True
            if ch == "{":
                self.stack.append("{")
                self.mode = KEY_START
                return True
            if ch == "[":
                self.stack.append("[")
                self.mode = V_START
                return True
            if ch == "]" and self.stack and self.stack[-1] == "[":
                # empty array
                self.stack.pop()
                self._value_done()
                return True
            if ch in _DIGITS or ch == "-":
                self.mode = IN_NUM
                self.num_text = ch
                return True
            if ch in "tfn":
                self.mode = IN_LIT
                self.lit_progress = ch
                return True
            return False
        if m == KEY_START:
            if ch in _WS:
                return True
            if ch == '"':
                self.mode = KEY_STR
                return True
            if ch == "}" and self.stack and self.stack[-1] == "{":
                self.stack.pop()
                self._value_done()
                return True
            return False
        if m == AFTER_KEY:
            if ch in _WS:
                return True
            if ch == ":":
                self.mode = V_START
                return True
            return False
        if m == AFTER_VAL:
            if ch in _WS:
                return True
            if not self.stack:
                return False
            top = self.stack[-1]
            if ch == ",":
                self.mode = KEY_START if top == "{" else V_START
                return True
            if ch == "}" and top == "{":
                self.stack.pop()
                self._value_done()
                return True
            if ch == "]" and top == "[":
                self.stack.pop()
                self._value_done()
                return True
            return False
        return False

    def _value_done(self) -> None:
        self.mode = AFTER_VAL if self.stack else DONE

    def feed_text(self, text: str) -> bool:
        for ch in text:
            if not self.feed(ch):
                return False
            self.text_len += 1
        return True

    def complete(self) -> bool:
        """The consumed text is one complete JSON value (possibly with
        trailing whitespace) — number-valued documents count once their
        digits can no longer continue."""
        if self.mode == DONE:
            return True
        return (self.mode == IN_NUM and not self.stack
                and _valid_number(self.num_text))

    def state_class(self) -> tuple:
        """Hashable key for the mask cache. Number/literal states fold
        their progress text in (it changes what may follow); container
        states fold in the stack TOP only (the full stack is handled by
        the dynamic close-token check)."""
        top = self.stack[-1] if self.stack else ""
        depth1 = len(self.stack) == 1
        if self.mode == IN_NUM:
            return (IN_NUM, _num_shape(self.num_text), top, depth1)
        if self.mode == IN_LIT:
            return (IN_LIT, self.lit_progress, top, depth1)
        if self.mode in (IN_STR_U, KEY_U):
            return (self.mode, str(self.hex_left), top, depth1)
        return (self.mode, "", top, depth1)


def _plausible_number(t: str) -> bool:
    """Is t a prefix of some valid JSON number?"""
    import re

    return re.fullmatch(
        r"-?(0|[1-9][0-9]*)?(\.[0-9]*)?([eE][+-]?[0-9]*)?", t) is not None


def _valid_number(t: str) -> bool:
    import re

    return re.fullmatch(
        r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?", t) is not None


def _num_shape(t: str) -> str:
    """Collapse number text to the features that matter for what may
    follow (keeps the mask cache small across different digits)."""
    import re

    m = re.fullmatch(r"(-?)(0|[1-9][0-9]*)?(\.([0-9]*))?([eE]([+-]?)([0-9]*))?", t)
    if m is None:
        return "?"
    sign, intpart, dot, frac, exp, esign, edig = m.groups()
    return "".join([
        "-" if sign else "",
        "0" if intpart == "0" else ("i" if intpart else ""),
        ("." + ("f" if frac else "")) if dot else "",
        ("e" + ("s" if esign else "") + ("d" if edig else "")) if exp else "",
    ])


# ---------------------------------------------------------------------------
# Token classification: per state-class, which vocab tokens keep the
# output inside the JSON grammar.


class JsonTokenMasker:
    """Per-tokenizer mask provider. mask(state) -> bool[V] (True =
    allowed). Class masks are computed lazily per state_class with
    stack-dependent close tokens resolved per call."""

    def __init__(self, token_texts: "list[str]", eos_id: int):
        self.token_texts = token_texts
        self.V = len(token_texts)
        self.eos_id = eos_id
        self._class_cache: dict[tuple, np.ndarray] = {}
        # Tokens whose text touches closing brackets — revalidated
        # against the live stack each step.
        self._closers = [i for i, t in enumerate(token_texts)
                         if t and ("}" in t or "]" in t)]

    def mask(self, state: JsonState) -> np.ndarray:
        key = state.state_class()
        base = self._class_cache.get(key)
        if base is None:
            base = self._compute_class_mask(state)
            self._class_cache[key] = base
        if len(state.stack) <= 1:
            # depth<=1 is part of the class key: closers fully resolved.
            out = base.copy()
        else:
            # Deeper nesting: closer tokens may pop through multiple
            # levels — validate them against the real stack.
            out = base.copy()
            for i in self._closers:
                t = self.token_texts[i]
                if t:
                    out[i] = _token_ok(state, t)
        out[self.eos_id] = state.complete()
        return out

    def _compute_class_mask(self, state: JsonState) -> np.ndarray:
        out = np.zeros((self.V,), dtype=bool)
        for i, t in enumerate(self.token_texts):
            if not t:
                continue
            out[i] = _token_ok(state, t)
        return out


def _token_ok(state: JsonState, text: str) -> bool:
    s = state.clone()
    return s.feed_text(text)


# ---------------------------------------------------------------------------
# Per-request guided state


class GuidedJson:
    """Constraint state attached to one decode slot.

    mode "json_object": output must be one JSON value whose top level is
    an OBJECT (OpenAI json_object contract). mode "json_schema": same
    grammar constraint; the finished text additionally validates against
    the schema (errors surface in the request output)."""

    def __init__(self, masker: JsonTokenMasker, mode: str = "json_object",
                 schema: "dict | None" = None):
        self.masker = masker
        self.mode = mode
        self.schema = schema
        self.state = JsonState()
        self._text: list[str] = []
        self._forced_object = mode in ("json_object", "json_schema")
        self.violated = False

    def allowed_mask(self) -> np.ndarray:
        m = self.masker.mask(self.state)
        if self._forced_object and self.state.mode == V_START \
                and not self.state.stack:
            # Top level must open an object: restrict the first
            # non-whitespace structural choice to '{' (or whitespace).
            keep = np.zeros_like(m)
            for i, t in enumerate(self.masker.token_texts):
                if not t or not m[i]:
                    continue
                stripped = t.lstrip(_WS)
                if stripped == "" or stripped.startswith("{"):
                    keep[i] = True
            m = keep
        return m

    def accept(self, token_id: int) -> None:
        text = self.masker.token_texts[token_id]
        if token_id == self.masker.eos_id:
            return
        if not self.state.feed_text(text):
            self.violated = True
        self._text.append(text)

    def finished_ok(self) -> "tuple[bool, str | None]":
        """(valid, error). Called when the sequence ends."""
        if self.violated:
            return False, "output violated the JSON grammar"
        if not self.state.complete():
            return False, "output is not a complete JSON value"
        if self.mode == "json_schema" and self.schema is not None:
            try:
                value = json.loads("".join(self._text))
            except json.JSONDecodeError as e:  # pragma: no cover
                return False, f"output is not parseable JSON: {e}"
            err = validate_schema(value, self.schema)
            if err:
                return False, f"schema validation failed: {err}"
        return True, None


# ---------------------------------------------------------------------------
# Minimal dependency-free JSON-schema validation (the subset the
# reference's strict metaschema path covers in practice: type, enum,
# const, properties/required/additionalProperties, items, nested).


def validate_schema(value: Any, schema: dict) -> "str | None":
    """Returns an error string or None. Small, strict subset."""
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, x) for x in types):
            return f"expected type {t}, got {type(value).__name__}"
    if "enum" in schema and value not in schema["enum"]:
        return f"{value!r} not in enum {schema['enum']!r}"
    if "const" in schema and value != schema["const"]:
        return f"{value!r} != const {schema['const']!r}"
    if isinstance(value, dict):
        props = schema.get("properties", {})
        for k in schema.get("required", ()):
            if k not in value:
                return f"missing required property {k!r}"
        if schema.get("additionalProperties") is False:
            extra = set(value) - set(props)
            if extra:
                return f"unexpected properties {sorted(extra)!r}"
        for k, sub in props.items():
            if k in value and isinstance(sub, dict):
                err = validate_schema(value[k], sub)
                if err:
                    return f"{k}: {err}"
    if isinstance(value, list):
        items = schema.get("items")
        if isinstance(items, dict):
            for i, it in enumerate(value):
                err = validate_schema(it, items)
                if err:
                    return f"[{i}]: {err}"
    return None


def _type_ok(value: Any, t: str) -> bool:
    if t == "object":
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, list)
    if t == "string":
        return isinstance(value, str)
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "boolean":
        return isinstance(value, bool)
    if t == "null":
        return value is None
    return True
