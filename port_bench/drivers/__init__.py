"""The drivers a traffic mix names (its ``"driver"`` key): each has
``setup(run) -> state``, ``window(run, state)`` and ``check(run, state)``.

* ``synth_offline``: back-to-back ``synthesize_fn`` calls, one queued
  ahead, each call's waveforms copied to pinned host memory.
* ``train_step``: back-to-back ``build_step`` iterations in the n_critic
  pattern on a device-resident corpus.
"""
