"""graftlint fixture — prof-counter wire decoder out of sync with the
fixture's native ProfCounters struct (../csrc/kmamiz_spans.cpp).

Two seeded violations, both anchored on the _PROF_SCALARS line: the
struct's `new_counter_ns` scalar is missing here, and `ghost_ns` below
names a scalar the struct no longer has.
"""

_PROF_SCALARS_V1 = (
    "parses",
    "spans",
)
_PROF_SCALARS = _PROF_SCALARS_V1 + ("fold_ns", "ghost_ns")  # EXPECT: prof-counter-wire
