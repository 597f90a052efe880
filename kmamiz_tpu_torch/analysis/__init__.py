"""Runtime checks of the hot path's invariants (counterpart of
kmamiz_tpu/analysis/; its static lint and concurrency rules are not
ported yet)."""
