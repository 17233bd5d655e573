"""CompileGuard: the capture budget of the port's compiled serve steps (the
port's copy of ``repro.runtime.compile_guard``, which is pure Python).

The port compiles a serve step by capturing it as a CUDA graph
(:mod:`repro_torch.runtime.graphs`), once per key of static shapes.  A
new shape silently captures again: nothing fails, but every capture
costs an eager step, a capture and device memory in the graphs' pool.
The engine keeps the number of captures O(log k) (one chunk width for
the ragged step, the pow2 ladder of burst lengths), and this module makes
that invariant enforced:

  * :meth:`CompileGuard.declare_jit` registers a compiled program (any
    object with a ``_cache_size()`` probe: a
    :class:`~repro_torch.runtime.graphs.StepGraphs` counts its captures)
    together with a BUDGET, the most new cache entries it may accrue while
    the guard watches.  The baseline is snapshotted at declaration.
    Re-declaring the same program ACCUMULATES budget.
  * :meth:`CompileGuard.wrap_counter` patches a module attribute with a
    counting wrapper (restored on guard exit), for "this helper must
    never run on the hot path" pins (budget 0).
  * :meth:`CompileGuard.check` raises :class:`CompileBudgetExceeded`
    naming the offending program, its count and its budget.  The
    serving engine calls it after every iteration.

Activation: guards form a stack via ``with CompileGuard()`` (innermost
wins).  When the environment variable ``REPRO_COMPILE_GUARD=1`` is set
and no explicit guard is active, :func:`current` lazily creates a
process-global ambient guard.  With the stack empty and the variable
unset, :func:`current` returns ``None`` and the instrumented call sites
cost one dict lookup.

The messages say "compiles", as the reference's do: a capture is the
port's compile.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

ENV_FLAG = "REPRO_COMPILE_GUARD"

__all__ = [
    "CompileBudgetExceeded",
    "CompileGuard",
    "current",
    "enabled",
    "reset_global",
]


class CompileBudgetExceeded(RuntimeError):
    """A watched program compiled (or a counted helper ran) more times
    than its declared budget.  The message names the program, the
    observed count and the budget — by construction the violation is a
    compile-discipline bug (retrace on the hot path), never load."""


class _JitDecl:
    """One watched jitted program: baseline cache size + budget, plus a
    per-owner ledger of budget contributions (``owners`` maps an owner
    token to ``[contributed_budget, cache_size_at_declaration]``) so a
    dropped owner's allowance can be reclaimed without disturbing the
    other declarers' accounting."""

    __slots__ = ("name", "fn", "budget", "base", "owners")

    def __init__(self, name, fn, budget, owner=None):
        self.name, self.fn, self.budget = name, fn, int(budget)
        self.base = fn._cache_size()
        self.owners = {}
        if owner is not None:
            self.owners[owner] = [int(budget), self.base]

    def count(self):
        # monotone: jit caches only grow, so the delta is exactly the
        # number of compiles since declaration
        return self.fn._cache_size() - self.base

    def add_budget(self, extra, owner=None):
        self.budget += int(extra)
        if owner is not None:
            entry = self.owners.get(owner)
            if entry is None:
                self.owners[owner] = [int(extra), self.fn._cache_size()]
            else:
                entry[0] += int(extra)

    def release_owner(self, owner):
        """Reclaim ``owner``'s budget contribution.  Compiles are
        forgiven conservatively: at most the owner's own contribution,
        at most the compiles that happened SINCE the owner declared
        (earlier compiles cannot be its), and never below a zero count —
        so a retrace that overdrew the shared budget stays visible after
        the churned owner is gone."""
        entry = self.owners.pop(owner, None)
        if entry is None:
            return False
        contrib, snap = entry
        self.budget -= contrib
        since_owner = self.fn._cache_size() - max(snap, self.base)
        self.base += max(0, min(contrib, since_owner, self.count()))
        return True


class _CounterDecl:
    """One wrapped callable: explicit call count + budget."""

    __slots__ = ("name", "budget", "calls")

    def __init__(self, name, budget):
        self.name, self.budget, self.calls = name, int(budget), 0

    def count(self):
        return self.calls

    def add_budget(self, extra):
        self.budget += int(extra)


class CompileGuard:
    """Context manager tracking compile counts against declared budgets.

    Not thread-safe for concurrent declaration (declare from the thread
    that owns the engine); :meth:`check` reads are safe from any thread.
    """

    def __init__(self, name: str = "compile-guard"):
        self.name = name
        self._decls: Dict[str, object] = {}
        self._patches: List[tuple] = []  # (module, attr, original)

    # ---------------- declaration ----------------

    def declare_jit(self, name: str, jitted, budget: int, owner=None):
        """Watch ``jitted`` (anything with ``_cache_size()``) under
        ``name``.  Baseline = its current cache size.  Re-declaring the
        same name accumulates budget (shared module-level jits: each
        declarer brings its own allowance); the baseline is NOT moved,
        so compiles between declarations still count.

        ``owner`` (any hashable token, e.g. one per engine instance)
        keys the contribution in a per-owner ledger:
        :meth:`release_owner` later subtracts exactly this owner's
        allowance again — so a long-lived process that churns engines
        does not accumulate unbounded allowance on the shared
        module-level jits.  Ownerless declarations keep the legacy
        accumulate-forever behavior."""
        d = self._decls.get(name)
        if d is not None:
            d.add_budget(budget, owner)
        else:
            self._decls[name] = _JitDecl(name, jitted, budget, owner)
        return self

    def release_owner(self, owner) -> int:
        """Reclaim every budget contribution declared under ``owner``
        (engine drop).  Compiles attributable to the owner are forgiven
        conservatively — bounded by its contribution AND by the compiles
        observed since it declared — so reclaiming a churned engine
        never hides an unrelated retrace overdraft.  Returns the number
        of declarations adjusted.  Unknown owners are a no-op (safe to
        call from finalizers)."""
        n = 0
        for d in self._decls.values():
            if isinstance(d, _JitDecl) and d.release_owner(owner):
                n += 1
        return n

    def wrap_counter(self, module, attr: str, budget: int = 0,
                     name: Optional[str] = None):
        """Patch ``module.attr`` with a counting wrapper (restored when
        the guard exits).  Budget 0 pins "never runs while guarded".
        Re-wrapping the same (module, attr) accumulates budget on the
        existing counter instead of double-wrapping."""
        key = name or f"{getattr(module, '__name__', module)}.{attr}"
        d = self._decls.get(key)
        if isinstance(d, _CounterDecl):
            d.add_budget(budget)
            return d
        decl = _CounterDecl(key, budget)
        self._decls[key] = decl
        original = getattr(module, attr)

        def counting(*args, **kwargs):
            decl.calls += 1
            return original(*args, **kwargs)

        counting.__wrapped__ = original
        setattr(module, attr, counting)
        self._patches.append((module, attr, original))
        return decl

    # ---------------- inspection / enforcement ----------------

    def counts(self) -> Dict[str, tuple]:
        """{name: (count, budget)} for every declaration."""
        return {n: (d.count(), d.budget) for n, d in self._decls.items()}

    def count(self, name: str) -> int:
        return self._decls[name].count()

    def violations(self) -> List[tuple]:
        return [(n, c, b) for n, (c, b) in sorted(self.counts().items())
                if c > b]

    def check(self):
        """Raise :class:`CompileBudgetExceeded` if any watched program
        is over budget.  Cheap when clean: one ``_cache_size()`` int
        read per declaration, no tracing, no device sync."""
        bad = self.violations()
        if bad:
            lines = ", ".join(f"{n}: {c} compiles > budget {b}"
                              for n, c, b in bad)
            raise CompileBudgetExceeded(
                f"[{self.name}] compile budget exceeded — {lines}. "
                f"A watched program retraced beyond its declared shape "
                f"family (new shape, new static arg, or an in-function "
                f"jit); fix the call site or raise the declared budget "
                f"with justification.")

    def summary(self) -> str:
        if not self._decls:
            return f"[{self.name}] no programs declared"
        rows = [f"  {n}: {c}/{b} compiles{' OVER' if c > b else ''}"
                for n, (c, b) in sorted(self.counts().items())]
        return "\n".join([f"[{self.name}] compile budgets:"] + rows)

    # ---------------- stacking ----------------

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        elif self in _STACK:          # tolerate out-of-order exits
            _STACK.remove(self)
        # restore wrapped attributes in reverse patch order
        while self._patches:
            module, attr, original = self._patches.pop()
            setattr(module, attr, original)
        return False


_STACK: List[CompileGuard] = []
_GLOBAL: Optional[CompileGuard] = None


def enabled() -> bool:
    """True when ``REPRO_COMPILE_GUARD=1`` asks for ambient guarding."""
    return os.environ.get(ENV_FLAG, "") == "1"


def current() -> Optional[CompileGuard]:
    """The active guard: innermost ``with CompileGuard()`` if any, else
    a lazily-created process-global guard when ``REPRO_COMPILE_GUARD=1``,
    else ``None`` (instrumented call sites no-op)."""
    if _STACK:
        return _STACK[-1]
    if enabled():
        global _GLOBAL
        if _GLOBAL is None:
            _GLOBAL = CompileGuard("compile-guard[env]")
        return _GLOBAL
    return None


def reset_global():
    """Drop the ambient env-var guard (tests: isolate declarations)."""
    global _GLOBAL
    _GLOBAL = None
