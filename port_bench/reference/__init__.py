"""The plain reference the benchmark holds the port against.

Plain float32 PyTorch (``F.conv2d``, ``torch.fft``, autograd), run with
TF32 off.  It imports nothing of the program: it reads the shipped
checkpoint with ``torch.load`` into its own layers and takes every other
input (weights of the train cell, latents, batches, noise) from the
benchmark, which hands the same to the program.

* ``synthesis``: the generator (8 blocks and the head, no fade at alpha 1)
  and the vocoder (magnitude / instantaneous-frequency image to
  waveform), after the reference repository's ``generator.py`` and
  ``audio/functions.py``.
* ``training``: the WGAN-GP iteration (critic on the real and the fake
  batch, the gradient penalty by double backward, Adam with per-leaf step
  counts, the generator against the updated critic every ``n_critic``-th
  iteration).
* ``compare``: the numbers that decide ``correct``.
* ``lower``: the controls, the same computation in the precision below the
  one that the configuration states.
"""
