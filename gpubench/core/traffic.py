"""The one traffic generator: it reads a traffic file (``gpubench/traffic/
<cell>.json``) and the configuration's statement texts, and gives each
client its list of statements, drawn from the run's seed.

A traffic file holds:

- ``clients``: closed-loop clients, one Session and one thread each;
- ``order``: ``sequence`` (every client sends ``sequence``, or its own list
  from ``sequences``, in order and again from the start) or
  ``shuffled_blocks`` (each block holds every name of ``mix`` as many times
  as its weight, in an order drawn afresh for each block, so that every seed
  sends the same mix);
- ``literals``: drawn in order for every statement; each a ``normal``
  ``[mean, sd]`` (with ``round`` digits), ``integers`` ``[low, high)`` whose
  bounds may be arithmetic over earlier literals, or an ``expr``; a list
  for every statement, or a map from statement name to its own list;
- ``statements_per_client``: how many a client's list holds before it
  repeats (``shuffled_blocks``);
- ``warmup``: before the window, after one run of each statement name:
  ``passes`` over every client's statements, one client after the other,
  and then ``seconds`` of the closed loop itself;
- ``profile``: the slice of a traced window under the device profiler;
- ``check``: ``sample``, how many of the window's statements the reference
  judges (0: every one).
"""

from __future__ import annotations

import ast
import operator
from dataclasses import dataclass, field

import numpy as np

_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv}


@dataclass(frozen=True)
class Stmt:
    name: str                  # the statement's name in the configuration
    sql: str
    args: dict = field(default_factory=dict, compare=False, hash=False)


def arith(expr, env: dict):
    """A number, or ``+ - * //`` over numbers and names of ``env``."""
    if isinstance(expr, (int, float)):
        return expr

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return n.value
        if isinstance(n, ast.Name):
            return env[n.id]
        if isinstance(n, ast.BinOp) and type(n.op) in _OPS:
            return _OPS[type(n.op)](ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        raise ValueError(f"not a literal expression: {expr!r}")

    return ev(ast.parse(str(expr), mode="eval"))


def draw_literals(specs: list, rng) -> dict:
    out: dict = {}
    for s in specs:
        if "normal" in s:
            mean, sd = s["normal"]
            x = float(rng.normal(mean, sd))
            out[s["name"]] = round(x, int(s["round"])) if "round" in s else x
        elif "integers" in s:
            lo, hi = (int(arith(b, out)) for b in s["integers"])
            out[s["name"]] = int(rng.integers(lo, hi))
        elif "expr" in s:
            out[s["name"]] = arith(s["expr"], out)
        else:
            raise ValueError(f"literal without a distribution: {s}")
    return out


def _names(traffic: dict, rng) -> list[str]:
    n = int(traffic["statements_per_client"])
    mix = traffic["mix"]
    block = [k for k, w in mix.items() for _ in range(int(w))]
    out: list[str] = []
    while len(out) < n:
        out += [block[i] for i in rng.permutation(len(block))]
    return out[:n]


def client_streams(config: dict, traffic: dict, seed: int) -> list[list[Stmt]]:
    """Each client's statements, the same for the same seed."""
    texts = config["statements"]
    clients = int(traffic["clients"])
    if traffic["order"] not in ("sequence", "shuffled_blocks"):
        raise ValueError(f"unknown traffic order {traffic['order']!r}")
    if traffic["order"] == "sequence":
        seqs = traffic.get("sequences") or [traffic["sequence"]] * clients
        return [[Stmt(q, texts[q]) for q in seq] for seq in seqs[:clients]]
    out = []
    for c in range(clients):
        rng = np.random.default_rng([int(seed), 1 + c])
        mine = []
        lits = traffic.get("literals", [])
        for name in _names(traffic, rng):
            args = draw_literals(lits.get(name, []) if isinstance(lits, dict) else lits, rng)
            mine.append(Stmt(name, texts[name].format(**args), args))
        out.append(mine)
    return out

