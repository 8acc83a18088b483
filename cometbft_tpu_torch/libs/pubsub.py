"""Query-subscription pubsub server (the port's copy of
`cometbft_tpu.libs.pubsub`; CometBFT libs/pubsub/).

Events are published with a map of composite-keyed attributes
(`tm.event`, `tx.height`, ...), each key holding a list of string
values; subscribers register a compiled Query and receive messages on a
bounded queue. The query language mirrors libs/pubsub/query/syntax:

    tm.event = 'NewBlock' AND tx.height > 5 AND tx.hash CONTAINS 'ab'
    account.owner EXISTS

Operators: = < <= > >= CONTAINS EXISTS, joined by AND.
"""

from __future__ import annotations

import queue
import re
import threading
from . import lockrank
from dataclasses import dataclass, field


class QueryError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<op><=|>=|=|<|>)
      | (?P<contains>CONTAINS\b)
      | (?P<exists>EXISTS\b)
      | (?P<and>AND\b)
      | (?P<str>'[^']*')
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<date>(?:DATE|TIME)\s+\S+)
      | (?P<key>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""", re.VERBOSE)


def _tokenize(s: str) -> list[tuple[str, str]]:
    toks, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise QueryError(f"cannot tokenize query at: {s[pos:]!r}")
        pos = m.end()
        kind = m.lastgroup
        toks.append((kind, m.group(kind)))
    return toks


@dataclass(frozen=True)
class Condition:
    key: str
    op: str  # '=', '<', '<=', '>', '>=', 'CONTAINS', 'EXISTS'
    value: str | float | None = None

    def matches(self, values: list[str]) -> bool:
        if self.op == "EXISTS":
            return True  # key presence is checked by the caller
        for v in values:
            if self.op == "=":
                if isinstance(self.value, float):
                    try:
                        if float(v) == self.value:
                            return True
                    except ValueError:
                        pass
                elif v == self.value:
                    return True
            elif self.op == "CONTAINS":
                if str(self.value) in v:
                    return True
            else:  # ordered comparison
                try:
                    t: float | str = float(self.value)
                    numeric = True
                except (TypeError, ValueError):
                    numeric = False
                if numeric:
                    # numeric operand: non-numeric values never match
                    try:
                        x: float | str = float(v)
                    except ValueError:
                        continue
                else:
                    # DATE/TIME operand: ISO-8601 sorts correctly as text
                    x, t = str(v), str(self.value)
                if ((self.op == "<" and x < t)
                        or (self.op == "<=" and x <= t)
                        or (self.op == ">" and x > t)
                        or (self.op == ">=" and x >= t)):
                    return True
        return False


class Query:
    """Compiled conjunctive query (libs/pubsub/query/query.go Compile)."""

    def __init__(self, conditions: list[Condition], source: str = ""):
        self.conditions = conditions
        self.source = source

    @staticmethod
    def parse(s: str) -> "Query":
        toks = _tokenize(s)
        conds: list[Condition] = []
        i = 0
        while i < len(toks):
            kind, val = toks[i]
            if kind != "key":
                raise QueryError(f"expected key, got {val!r}")
            key = val
            i += 1
            if i >= len(toks):
                raise QueryError(f"dangling key {key!r}")
            kind, val = toks[i]
            if kind == "exists":
                conds.append(Condition(key, "EXISTS"))
                i += 1
            elif kind == "contains":
                i += 1
                if i >= len(toks) or toks[i][0] != "str":
                    raise QueryError("CONTAINS requires a string operand")
                conds.append(Condition(key, "CONTAINS", toks[i][1][1:-1]))
                i += 1
            elif kind == "op":
                op = val
                i += 1
                if i >= len(toks):
                    raise QueryError(f"dangling operator {op!r}")
                okind, oval = toks[i]
                if okind == "str":
                    operand: str | float = oval[1:-1]
                elif okind == "num":
                    operand = float(oval)
                elif okind == "date":
                    operand = oval.split(None, 1)[1]
                else:
                    raise QueryError(f"bad operand {oval!r}")
                conds.append(Condition(key, op, operand))
                i += 1
            else:
                raise QueryError(f"expected operator after {key!r}")
            if i < len(toks):
                if toks[i][0] != "and":
                    raise QueryError(f"expected AND, got {toks[i][1]!r}")
                i += 1
                if i >= len(toks):
                    raise QueryError("dangling AND")
        return Query(conds, s)

    def matches(self, events: dict[str, list[str]]) -> bool:
        """All conditions satisfied by the event attribute map
        (query.go Matches)."""
        for c in self.conditions:
            vals = events.get(c.key)
            if vals is None:
                return False
            if not c.matches(vals):
                return False
        return True

    def __str__(self) -> str:
        return self.source

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and \
            self.conditions == other.conditions

    def __hash__(self) -> int:
        return hash(tuple(self.conditions))


ALL = Query([], "empty")  # matches everything (query.All)


@dataclass
class Message:
    data: object
    events: dict[str, list[str]] = field(default_factory=dict)


class Subscription:
    """A subscriber's bounded delivery queue. `canceled` is set with a
    reason when the server terminates the subscription (unsubscribed or
    overflow)."""

    def __init__(self, capacity: int = 100):
        self.out: queue.Queue[Message] = queue.Queue(capacity)
        self.canceled = threading.Event()
        self.cancel_reason: str | None = None

    def next(self, timeout: float | None = None) -> Message | None:
        try:
            return self.out.get(timeout=timeout)
        except queue.Empty:
            return None

    def _cancel(self, reason: str) -> None:
        self.cancel_reason = reason
        self.canceled.set()


class Server:
    """Pubsub hub (libs/pubsub/pubsub.go Server). Publishing is
    synchronous fan-out; a full subscriber queue cancels that subscriber
    (CometBFT's non-buffered semantics with client timeout)."""

    def __init__(self):
        self._mtx = lockrank.RankedRLock("pubsub")
        # subscriber -> {query -> Subscription}
        self._subs: dict[str, dict[Query, Subscription]] = {}

    def subscribe(self, subscriber: str, query: Query,
                  capacity: int = 100) -> Subscription:
        with self._mtx:
            by_query = self._subs.setdefault(subscriber, {})
            if query in by_query:
                raise ValueError(
                    f"{subscriber!r} already subscribed to {query}")
            sub = Subscription(capacity)
            by_query[query] = sub
            return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        with self._mtx:
            by_query = self._subs.get(subscriber, {})
            sub = by_query.pop(query, None)
            if sub is None:
                raise KeyError(f"{subscriber!r} not subscribed to {query}")
            if not by_query:
                self._subs.pop(subscriber, None)
        sub._cancel("unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._mtx:
            by_query = self._subs.pop(subscriber, None)
        if not by_query:
            raise KeyError(f"{subscriber!r} has no subscriptions")
        for sub in by_query.values():
            sub._cancel("unsubscribed")

    def num_clients(self) -> int:
        with self._mtx:
            return len(self._subs)

    def num_client_subscriptions(self, subscriber: str) -> int:
        with self._mtx:
            return len(self._subs.get(subscriber, {}))

    def publish(self, data: object,
                events: dict[str, list[str]] | None = None) -> None:
        events = events or {}
        msg = Message(data, events)
        with self._mtx:
            targets = [
                (name, q, sub)
                for name, by_query in self._subs.items()
                for q, sub in by_query.items()
                if q.matches(events)
            ]
        dead = []
        for name, q, sub in targets:
            try:
                sub.out.put_nowait(msg)
            except queue.Full:
                dead.append((name, q, sub))
        for name, q, sub in dead:
            with self._mtx:
                by_query = self._subs.get(name, {})
                if by_query.get(q) is sub:
                    by_query.pop(q, None)
                    if not by_query:
                        self._subs.pop(name, None)
            sub._cancel("client is not pulling messages fast enough")
