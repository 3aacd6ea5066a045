"""Grammar-constrained decoding: a per-request automaton whose allow-set
rides the engine's step as an additive bias on the held logits
(counterpart of `paddle_tpu/serving/grammar.py`, pure host code).

Each constrained request carries a host-side token-level automaton (one
instance per request, like a `Drafter`). Each step the engine turns the
automaton's allow-set into one [V] f32 row, 0.0 where a token is allowed
and `NEG_BIAS` (-1e30) where it is forbidden, and adds it to the row's
held logits before the sampling epilogue: the same argmax (K12 under the
megakernel) and the same top-k/top-p chain serve constrained and
unconstrained rows. With speculative decoding on, each verify column gets
the row of the state reached along the drafted path, so a draft the
grammar forbids loses the argmax match and the greedy acceptance rejects
it.

The built-in grammars are CHARACTER-level machines (a JSON pushdown
automaton, a literal-set trie, a Thompson-NFA regex subset) lifted to the
token vocabulary through a `token_strings` table (token id -> its text):
a token is allowed in a state iff feeding its characters one by one keeps
the machine alive, and a token that decodes to nothing is never allowed.
Without a tokenizer the default table maps token id i to `chr(i)`.

The lift here computes what the JAX package's does, per token, but by
CHARACTER CLASS: each machine names, through `char_key`, the classes of
characters its `step` cannot tell apart (the JSON machine reads a char
only through its punctuation, digits, escapes and literal letters and
otherwise through `ord(ch) >= 0x20`; the trie only through the choices'
alphabet; the regex only through its matchers' verdicts). A new state
then costs one `step` per class (a few dozen) and a few numpy passes over
the vocabulary, where a step per token costs tens of milliseconds at a
50k vocabulary; tokens of more than one character take the per-token
walk. Allow-masks, successor states, bounded reachability and budget
masks are memoised per state in tables that `fork()` clones share, and
that `GrammarSpec.make` shares across requests of one spec and token
table: they are pure functions of the machine, so sharing changes no
result.

Budget-aware closing: `budget_allowed(left)` keeps only the tokens from
which an accepting state stays reachable within `left - 1` more tokens;
when acceptance is out of reach altogether the unrestricted set is
returned (a stream truncated by length beats one steered into a dead
end). A constrained request needs `eos_token_id`: the engine allows EOS
exactly in accepting states and forces it when nothing else is allowed.
"""
from __future__ import annotations

import functools
import os
from abc import ABC, abstractmethod
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "GRAMMAR_ENV", "resolve_grammar_flag", "GrammarSpec", "TokenGrammar",
    "CharTokenGrammar", "JsonGrammar", "ChoiceGrammar", "RegexGrammar",
    "default_token_strings", "NEG_BIAS",
]

GRAMMAR_ENV = "PADDLE_TPU_GRAMMAR"

# the "minus infinity" the bias adds to forbidden logits: finite, so no
# softmax sees an inf or a nan, and far below any model logit
NEG_BIAS = -1e30


def resolve_grammar_flag(override=None) -> bool:
    """Whether the engine accepts grammar-constrained requests: an
    explicit `ServingEngine(grammar=...)` wins (a bool or an on/off
    spelling); otherwise PADDLE_TPU_GRAMMAR (default off). Anything else
    raises ValueError."""
    if override is not None:
        if isinstance(override, bool):
            return override
        flag = str(override)
    else:
        flag = os.environ.get(GRAMMAR_ENV, "off")
    low = flag.strip().lower()
    if low in ("on", "1", "true", "yes"):
        return True
    if low in ("off", "0", "false", "no"):
        return False
    raise ValueError(
        f"{GRAMMAR_ENV} / grammar must be on|off, got {flag!r}")


@functools.lru_cache(maxsize=8)
def default_token_strings(vocab_size: int) -> Tuple[str, ...]:
    """The identity byte-vocab table: token id i decodes to chr(i). Stands
    in for a tokenizer's id->text table; the lift is the same. One tuple
    per vocabulary size, so requests share the lift's tables."""
    return tuple(chr(i) for i in range(int(vocab_size)))


# ---------------------------------------------------------------------------
# character-level machines (internal): start() -> state, step(state, ch)
# -> state | None, accepting(state) -> bool, char_key(ch) -> the class of
# ch (chars of one class step alike from every state). States are small
# hashable values, so the lift can memoise per-state tables.
# ---------------------------------------------------------------------------

_WS = " \t\n\r"
_DIGITS = "0123456789"
_HEX = "0123456789abcdefABCDEF"
# number sub-states in which the digits read so far already form a
# complete JSON number (a non-number char ends the literal there)
_NUM_DONE = ("zero", "int", "frac", "exp")
# every char `_JsonMachine.step` compares against
_JSON_CHARS = frozenset(_WS + _DIGITS + _HEX + '"-+.eE[]{}:,\\/bfnrtu'
                        + "truefalsenull")


class _JsonMachine:
    """Character-level JSON value machine (RFC 8259 values: object,
    array, string, number, true/false/null), with the container stack
    folded into the state tuple. Accepts exactly the strings
    `json.loads` accepts for the supported escapes (\\uXXXX included),
    including the leading-zero number rule."""

    def start(self):
        return ("val", ())

    def accepting(self, state) -> bool:
        mode = state[0]
        if mode == "after":
            return not state[1]
        if mode == "num":
            return state[1] in _NUM_DONE and not state[2]
        return False

    def char_key(self, ch):
        """The class of `ch` for the token lift: `step` reads a char only
        through membership in the JSON punctuation, digits, escapes and
        literal letters, and otherwise through `ord(ch) >= 0x20`."""
        return ch if ch in _JSON_CHARS else ord(ch) >= 0x20

    def step(self, state, ch):
        mode = state[0]
        if mode in ("val", "elem0"):
            stack = state[1]
            if ch in _WS:
                return state
            if ch == '"':
                return ("instr", stack)
            if ch == "-":
                return ("num", "sign", stack)
            if ch == "0":
                return ("num", "zero", stack)
            if ch in "123456789":
                return ("num", "int", stack)
            if ch == "[":
                return ("elem0", stack + ("A",))
            if ch == "{":
                return ("key0", stack + ("O",))
            if ch == "t":
                return ("lit", "rue", stack)
            if ch == "f":
                return ("lit", "alse", stack)
            if ch == "n":
                return ("lit", "ull", stack)
            if mode == "elem0" and ch == "]":
                return ("after", stack[:-1])
            return None
        if mode == "lit":
            rest, stack = state[1], state[2]
            if ch != rest[0]:
                return None
            if len(rest) == 1:
                return ("after", stack)
            return ("lit", rest[1:], stack)
        if mode == "num":
            sub, stack = state[1], state[2]
            if sub == "sign":
                if ch == "0":
                    return ("num", "zero", stack)
                if ch in "123456789":
                    return ("num", "int", stack)
                return None
            if sub in ("zero", "int"):
                if sub == "int" and ch in _DIGITS:
                    return state
                if ch == ".":
                    return ("num", "dot", stack)
                if ch in "eE":
                    return ("num", "e", stack)
            elif sub == "dot":
                return ("num", "frac", stack) if ch in _DIGITS else None
            elif sub == "frac":
                if ch in _DIGITS:
                    return state
                if ch in "eE":
                    return ("num", "e", stack)
            elif sub == "e":
                if ch in "+-":
                    return ("num", "esign", stack)
                return ("num", "exp", stack) if ch in _DIGITS else None
            elif sub == "esign":
                return ("num", "exp", stack) if ch in _DIGITS else None
            elif sub == "exp":
                if ch in _DIGITS:
                    return state
            if sub in _NUM_DONE:      # the number ended; re-read ch
                return self.step(("after", stack), ch)
            return None
        if mode in ("instr", "inkey"):
            stack = state[1]
            if ch == '"':
                return ("after", stack) if mode == "instr" \
                    else ("colon", stack)
            if ch == "\\":
                return ("esc" if mode == "instr" else "kesc", stack)
            return state if ord(ch) >= 0x20 else None
        if mode in ("esc", "kesc"):
            stack = state[1]
            back = "instr" if mode == "esc" else "inkey"
            if ch in '"\\/bfnrt':
                return (back, stack)
            if ch == "u":
                return ("u" if mode == "esc" else "ku", 4, stack)
            return None
        if mode in ("u", "ku"):
            k, stack = state[1], state[2]
            if ch not in _HEX:
                return None
            back = "instr" if mode == "u" else "inkey"
            return (back, stack) if k == 1 else (mode, k - 1, stack)
        if mode in ("key", "key0"):
            stack = state[1]
            if ch in _WS:
                return state
            if ch == '"':
                return ("inkey", stack)
            if mode == "key0" and ch == "}":
                return ("after", stack[:-1])
            return None
        if mode == "colon":
            stack = state[1]
            if ch in _WS:
                return state
            if ch == ":":
                return ("val", stack)
            return None
        if mode == "after":
            stack = state[1]
            if ch in _WS:
                return state
            if stack:
                top = stack[-1]
                if ch == ",":
                    return (("val", stack) if top == "A"
                            else ("key", stack))
                if top == "A" and ch == "]":
                    return ("after", stack[:-1])
                if top == "O" and ch == "}":
                    return ("after", stack[:-1])
            return None
        raise AssertionError(f"unknown JSON state {state!r}")


class _ChoiceMachine:
    """Trie over a fixed set of literal strings: the machine for enum/
    tool-name constraints. State is a trie node index."""

    def __init__(self, choices):
        # node -> {ch: node}; node -> terminal?
        self._next: List[Dict[str, int]] = [{}]
        self._done: List[bool] = [False]
        for text in choices:
            node = 0
            for ch in text:
                nxt = self._next[node].get(ch)
                if nxt is None:
                    nxt = len(self._next)
                    self._next.append({})
                    self._done.append(False)
                    self._next[node][ch] = nxt
                node = nxt
            self._done[node] = True
        self._alphabet = frozenset("".join(choices))

    def start(self):
        return 0

    def step(self, state, ch):
        return self._next[state].get(ch)

    def char_key(self, ch):
        """`step` is a trie lookup: a char off every choice never moves."""
        return ch if ch in self._alphabet else None

    def accepting(self, state) -> bool:
        return self._done[state]


class _RegexMachine:
    """Thompson-NFA over a pragmatic regex subset: literals, `.`,
    classes `[a-z0-9]` (ranges, leading `^` negation), escapes
    (`\\d \\w \\s` and literal `\\x`), quantifiers `* + ?`,
    alternation `|`, groups `( )`. Anchored both ends (the whole
    stream must match — that is what a structured-output constraint
    means). State is a frozenset of NFA node ids."""

    def __init__(self, pattern: str):
        # nodes: ("ch", matcher, nxt) | ("split", a, b) | ("match",)
        self._nodes: List[tuple] = []
        start, outs = self._parse_alt(pattern, 0)
        pos, frag_start = start
        if pos != len(pattern):
            raise ValueError(
                f"regex: unbalanced ')' at {pos} in {pattern!r}")
        match = self._emit(("match",))
        for node, slot in outs:
            self._patch(node, slot, match)
        self._start = frag_start

    # -- construction ------------------------------------------------------
    def _emit(self, node) -> int:
        self._nodes.append(node)
        return len(self._nodes) - 1

    def _patch(self, node: int, slot: int, target: int):
        ent = list(self._nodes[node])
        ent[slot] = target
        self._nodes[node] = tuple(ent)

    def _parse_alt(self, pat, pos):
        (pos, start), outs = self._parse_concat(pat, pos)
        while pos < len(pat) and pat[pos] == "|":
            (pos, start2), outs2 = self._parse_concat(pat, pos + 1)
            split = self._emit(("split", start, start2))
            start = split
            outs = outs + outs2
        return (pos, start), outs

    def _parse_concat(self, pat, pos):
        start = None
        outs: List[Tuple[int, int]] = []
        while pos < len(pat) and pat[pos] not in "|)":
            (pos, s), o = self._parse_repeat(pat, pos)
            if start is None:
                start = s
            else:
                for node, slot in outs:
                    self._patch(node, slot, s)
            outs = o
        if start is None:              # empty branch: eps fragment
            split = self._emit(("split", None, None))
            # both arms point the same way: a pure pass-through
            return (pos, split), [(split, 1), (split, 2)]
        return (pos, start), outs

    def _parse_repeat(self, pat, pos):
        (pos, start), outs = self._parse_atom(pat, pos)
        while pos < len(pat) and pat[pos] in "*+?":
            op = pat[pos]
            pos += 1
            if op == "*":
                split = self._emit(("split", start, None))
                for node, slot in outs:
                    self._patch(node, slot, split)
                start, outs = split, [(split, 2)]
            elif op == "+":
                split = self._emit(("split", start, None))
                for node, slot in outs:
                    self._patch(node, slot, split)
                outs = [(split, 2)]
            else:                      # ?
                split = self._emit(("split", start, None))
                start, outs = split, outs + [(split, 2)]
        return (pos, start), outs

    def _parse_atom(self, pat, pos):
        if pos >= len(pat):
            raise ValueError(f"regex: dangling operator in {pat!r}")
        ch = pat[pos]
        if ch == "(":
            (pos, start), outs = self._parse_alt(pat, pos + 1)
            if pos >= len(pat) or pat[pos] != ")":
                raise ValueError(f"regex: missing ')' in {pat!r}")
            return (pos + 1, start), outs
        if ch == "[":
            matcher, pos = self._parse_class(pat, pos + 1)
        elif ch == ".":
            matcher, pos = (lambda c: c not in "\n"), pos + 1
        elif ch == "\\":
            matcher, pos = self._escape(pat, pos + 1)
        elif ch in "*+?|)":
            raise ValueError(
                f"regex: unexpected {ch!r} at {pos} in {pat!r}")
        else:
            lit = ch
            matcher, pos = (lambda c, lit=lit: c == lit), pos + 1
        node = self._emit(("ch", matcher, None))
        return (pos, node), [(node, 2)]

    def _escape(self, pat, pos):
        if pos >= len(pat):
            raise ValueError(f"regex: dangling escape in {pat!r}")
        ch = pat[pos]
        table = {
            "d": lambda c: c.isdigit(),
            "w": lambda c: c.isalnum() or c == "_",
            "s": lambda c: c in _WS,
        }
        if ch in table:
            return table[ch], pos + 1
        return (lambda c, lit=ch: c == lit), pos + 1

    def _parse_class(self, pat, pos):
        negate = pos < len(pat) and pat[pos] == "^"
        if negate:
            pos += 1
        ranges: List[Tuple[str, str]] = []
        singles: List = []
        while pos < len(pat) and pat[pos] != "]":
            if pat[pos] == "\\":
                m, pos = self._escape(pat, pos + 1)
                singles.append(m)
                continue
            lo = pat[pos]
            if pos + 2 < len(pat) and pat[pos + 1] == "-" \
                    and pat[pos + 2] != "]":
                ranges.append((lo, pat[pos + 2]))
                pos += 3
            else:
                singles.append(lambda c, lit=lo: c == lit)
                pos += 1
        if pos >= len(pat):
            raise ValueError(f"regex: missing ']' in {pat!r}")

        def matcher(c, ranges=tuple(ranges), singles=tuple(singles),
                    negate=negate):
            hit = any(lo <= c <= hi for lo, hi in ranges) or \
                any(m(c) for m in singles)
            return hit != negate
        return matcher, pos + 1

    # -- simulation --------------------------------------------------------
    def _closure(self, ids) -> frozenset:
        seen = set()
        stack = list(ids)
        while stack:
            i = stack.pop()
            if i is None or i in seen:
                continue
            seen.add(i)
            node = self._nodes[i]
            if node[0] == "split":
                stack.append(node[1])
                stack.append(node[2])
        return frozenset(seen)

    def char_key(self, ch):
        """`step` reads a char only through the matchers of the "ch"
        nodes: chars they all judge alike move alike."""
        return tuple(node[1](ch) for node in self._nodes
                     if node[0] == "ch")

    def start(self):
        return self._closure([self._start])

    def step(self, state, ch):
        nxt = [node[2] for i in state
               if (node := self._nodes[i])[0] == "ch" and node[1](ch)]
        if not nxt:
            return None
        out = self._closure(nxt)
        return out if out else None

    def accepting(self, state) -> bool:
        return any(self._nodes[i][0] == "match" for i in state)


# ---------------------------------------------------------------------------
# token-level grammars
# ---------------------------------------------------------------------------

class TokenGrammar(ABC):
    """Host-side token-level automaton, one instance per constrained
    request: made at admission, advanced on every committed token,
    dropped at retirement, and made anew and replayed from the emitted
    history after preemption."""

    vocab_size: int

    @abstractmethod
    def allowed(self) -> np.ndarray:
        """bool[vocab]: tokens the automaton permits next."""

    @abstractmethod
    def advance(self, token: int) -> None:
        """Consume one committed token. Raises ValueError on a token the
        automaton forbids: committed tokens are sampled under its own
        mask, so one it forbids is a desync, not a model choice."""

    @abstractmethod
    def accepting(self) -> bool:
        """Whether the stream so far is complete under the grammar (EOS
        is legal here and only here)."""

    @abstractmethod
    def fork(self) -> "TokenGrammar":
        """An independent copy at the current state, for walking a
        speculative draft path. Memo tables are shared, state is not."""

    def budget_allowed(self, left: int) -> np.ndarray:
        """`allowed()` restricted to tokens that keep an accepting state
        reachable within `left - 1` further tokens. Default: no
        restriction."""
        return self.allowed()


class _State:
    """One machine state's lift: `sid[t]` indexes `succ` (the distinct
    states tokens lead to, in order of their first token) or is -1 where
    token t is forbidden; `mask` is `sid >= 0`."""

    __slots__ = ("succ", "sid", "mask")

    def __init__(self, succ, sid):
        self.succ = succ
        self.sid = sid
        self.mask = sid >= 0
        self.mask.setflags(write=False)


class _LiftTables:
    """Everything a machine's lift memoises, shared by forks and by the
    requests of one spec: the token table's character classes, each
    state's `_State`, bounded reachability and budget masks."""

    def __init__(self, machine, token_strings):
        self.machine = machine
        self.tok = tuple(token_strings)
        vocab = len(self.tok)
        keys: Dict = {}
        reps: List[str] = []
        cls = np.full(vocab, -1, np.int64)
        multi = []
        for t, text in enumerate(self.tok):
            if len(text) != 1:
                multi.append(t)         # the per-token walk (or never)
                continue
            key = machine.char_key(text)
            c = keys.get(key)
            if c is None:
                c = keys[key] = len(reps)
                reps.append(text)
            cls[t] = c
        self.cls = cls                  # token -> class, -1 off the classes
        self.reps = reps                # class -> one char of it
        self.multi = np.asarray(multi, np.int64)
        self.states: Dict = {}
        self.reach: Dict = {}
        self.budget: Dict = {}

    def walk(self, state, text: str):
        """The per-token lift: `text`'s chars fed one by one."""
        cur = state if text else None   # empty decode: never allowed
        for ch in text:
            cur = self.machine.step(cur, ch)
            if cur is None:
                break
        return cur

    def lift(self, state) -> _State:
        got = self.states.get(state)
        if got is not None:
            return got
        index: Dict = {}
        by_cls = np.full(len(self.reps) + 1, -1, np.int64)   # [-1] = off
        for c, ch in enumerate(self.reps):
            nxt = self.machine.step(state, ch)
            if nxt is not None:
                by_cls[c] = index.setdefault(nxt, len(index))
        sid = by_cls[self.cls]
        for t in self.multi:
            nxt = self.walk(state, self.tok[t])
            if nxt is not None:
                sid[t] = index.setdefault(nxt, len(index))
        # successors in order of their first token, as a per-token walk
        # meets them
        live = np.nonzero(sid >= 0)[0]
        uniq, first = np.unique(sid[live], return_index=True)
        order = uniq[np.argsort(first)]
        remap = np.zeros(max(1, len(index)), np.int64)
        remap[order] = np.arange(order.size)
        states = [None] * len(index)
        for nxt, i in index.items():
            states[i] = nxt
        got = _State([states[i] for i in order],
                     np.where(sid >= 0, remap[np.maximum(sid, 0)], -1))
        self.states[state] = got
        return got

    def accept_within(self, state, n: int) -> bool:
        """Bounded reachability: can `state` reach acceptance in at most
        `n` tokens? Memoised on (state, n); the recursion lowers n."""
        if self.machine.accepting(state):
            return True
        if n <= 0:
            return False
        key = (state, n)
        hit = self.reach.get(key)
        if hit is not None:
            return hit
        ok = any(self.accept_within(nxt, n - 1)
                 for nxt in self.lift(state).succ)
        self.reach[key] = ok
        return ok


class CharTokenGrammar(TokenGrammar):
    """A character-level machine lifted to the token vocabulary (module
    doc): the JAX class's masks, transitions and budget rule, memoised in
    `_LiftTables` shared across forks."""

    def __init__(self, machine, token_strings, _shared=None):
        self._t = (_shared if _shared is not None
                   else _LiftTables(machine, token_strings))
        self._m = self._t.machine
        self._tok = self._t.tok
        self.vocab_size = len(self._tok)
        self._state = self._m.start()

    def _tok_step(self, state, token: int):
        lifted = self._t.lift(state)
        i = int(lifted.sid[int(token)])
        return None if i < 0 else lifted.succ[i]

    # -- TokenGrammar ------------------------------------------------------
    def allowed(self) -> np.ndarray:
        return self._t.lift(self._state).mask

    def advance(self, token: int) -> None:
        nxt = self._tok_step(self._state, int(token))
        if nxt is None:
            raise ValueError(
                f"grammar: token {int(token)} "
                f"({self._tok[int(token)]!r}) is not allowed in the "
                "current state — committed-state desync")
        self._state = nxt

    def accepting(self) -> bool:
        return self._m.accepting(self._state)

    def fork(self) -> "CharTokenGrammar":
        dup = CharTokenGrammar.__new__(type(self))
        CharTokenGrammar.__init__(dup, self._m, self._tok, _shared=self._t)
        dup._state = self._state
        return dup

    def budget_allowed(self, left: int) -> np.ndarray:
        t = self._t
        lifted = t.lift(self._state)
        if left is None:
            return lifted.mask
        left = int(left)
        key = (self._state, left)
        hit = t.budget.get(key)
        if hit is not None:
            return hit
        out = lifted.mask
        if t.accept_within(self._state, left):
            ok = np.array([t.accept_within(nxt, left - 1)
                           for nxt in lifted.succ] + [False])
            keep = ok[lifted.sid]       # sid -1 reads the trailing False
            if keep.any() or self.accepting():
                # an empty set at an accepting state is meaningful: the
                # engine's EOS composition forces termination
                keep.setflags(write=False)
                out = keep
        t.budget[key] = out
        return out


class JsonGrammar(CharTokenGrammar):
    """JSON mode: any RFC 8259 value (object/array/string/number/
    true/false/null), container nesting tracked on a stack."""

    def __init__(self, token_strings, _shared=None):
        super().__init__(_JsonMachine(), token_strings, _shared)


class ChoiceGrammar(CharTokenGrammar):
    """The stream must be exactly one of a fixed set of literal
    strings (enum constraints, tool-name selection)."""

    def __init__(self, choices, token_strings, _shared=None):
        choices = tuple(str(c) for c in choices)
        if not choices or any(not c for c in choices):
            raise ValueError(
                "grammar: choice requires non-empty choices")
        super().__init__(_ChoiceMachine(choices), token_strings, _shared)


class RegexGrammar(CharTokenGrammar):
    """The stream must fully match a regex over the supported subset
    (see `_RegexMachine`)."""

    def __init__(self, pattern, token_strings, _shared=None):
        super().__init__(_RegexMachine(str(pattern)), token_strings,
                         _shared)


_KINDS = ("json_object", "choice", "regex")
# (spec, token table) -> the lift tables its requests share; the oldest
# drop first past _SHARED_MAX
_SHARED: "OrderedDict" = OrderedDict()
_SHARED_MAX = 32


@dataclass(frozen=True)
class GrammarSpec:
    """Declarative grammar constraint carried on `SamplingParams`: the
    request carries the spec, the engine makes the per-request automaton
    at admission. `token_strings` overrides the id->text table; None
    means the byte-vocab identity over the engine's vocab size."""

    kind: str
    choices: Optional[Tuple[str, ...]] = None
    pattern: Optional[str] = None
    token_strings: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"grammar kind must be one of {_KINDS}, "
                f"got {self.kind!r}")
        if self.kind == "choice":
            if not self.choices:
                raise ValueError(
                    "grammar kind 'choice' requires choices")
            object.__setattr__(self, "choices",
                               tuple(str(c) for c in self.choices))
        if self.kind == "regex" and not self.pattern:
            raise ValueError("grammar kind 'regex' requires pattern")

    def make(self, vocab_size: int) -> TokenGrammar:
        """A fresh automaton at its start state (its memo tables shared
        with earlier automata of this spec and table)."""
        toks = self.token_strings
        if toks is None:
            toks = default_token_strings(int(vocab_size))
        elif len(toks) != int(vocab_size):
            raise ValueError(
                f"grammar token_strings has {len(toks)} entries for "
                f"vocab {vocab_size}")
        key = (self.kind, self.choices, self.pattern, id(toks), len(toks))
        hit = _SHARED.get(key)
        if hit is not None and hit[0] is toks:
            _SHARED.move_to_end(key)
            shared = hit[1]
        else:
            shared = None
        if self.kind == "json_object":
            g = JsonGrammar(toks, shared)
        elif self.kind == "choice":
            g = ChoiceGrammar(self.choices, toks, shared)
        else:
            g = RegexGrammar(self.pattern, toks, shared)
        if shared is None:
            _SHARED[key] = (toks, g._t)
            while len(_SHARED) > _SHARED_MAX:
                _SHARED.popitem(last=False)
        return g

    def validates(self, text: str) -> bool:
        """Host-side full-string check (bench/test oracle): does
        `text` parse under this grammar?"""
        if self.kind == "json_object":
            import json
            try:
                json.loads(text)
                return True
            except (ValueError, TypeError):
                return False
        if self.kind == "choice":
            return text in self.choices
        m = _RegexMachine(self.pattern)
        state = m.start()
        for ch in text:
            state = m.step(state, ch)
            if state is None:
                return False
        return m.accepting(state)
