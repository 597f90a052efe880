"""graftrace: whole-repo concurrency analysis on the graftlint engine.

Two layers, same split as graftlint + analysis/guards.py:

- ``locks.py``    static lock model — every threading.Lock/RLock/Condition
                  site, held-set propagation through the call graph, the
                  interprocedural acquisition-order graph.
- ``rules.py``    three graftlint rules over that model (lock-order-cycle,
                  blocking-call-under-lock, inconsistent-guard).
- ``witness.py``  runtime lock-witness (KMAMIZ_LOCK_WITNESS=1): records
                  actual acquisition orders during soaks and cross-checks
                  them against the static model.

Counterpart of kmamiz_tpu/analysis/concurrency/; pure ``ast`` and
``threading``, like the rest of ``analysis/``: nothing here imports torch.
"""
