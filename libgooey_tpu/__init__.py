"""libgooey-tpu: a batched JAX audio synthesis framework.

A ground-up JAX/XLA rebuild of the capabilities of gooey-audio/libgooey
(a pure-Rust single-audio-thread synthesis engine).

Architecture (accelerator-first, not a port):

* **Voices are the batch axis.** All per-voice synth state lives in pytrees of
  ``[V, ...]`` arrays.  The reference's sequential ``for voice in ...`` loops
  (poly voices, grains, sampler voices, drum strips) become one vectorized
  program over the voice axis.
* **Blocks, not samples.** One jitted ``render_block(state, params, events)
  -> (state', audio[V, B])`` step renders ``B`` samples at once.  The
  reference's per-sample recursion maps onto three kernel classes:

  1. *stateless time-based math* (oscillators, envelopes, pan, waveshaping)
     — pure vectorized ops over ``[V, B]``;
  2. *recurrences* (one-pole smoothers/filters, SVF, biquads, nonlinear
     loops) — closed forms, blocked associative scans, and sample-
     sequential loops (``ops.scan``, ``ops.recurrence``);
  3. *delay-line systems* (delays, reverb tanks, sample playback)
     — HBM ring buffers with per-block gather/scatter.

* **Events, not callbacks.** Sequencer/transport/trigger logic runs host-side
  in exact float64 arithmetic (mirroring the reference's control thread) and
  compiles each block's decisions into dense event arrays (trigger offsets,
  velocities, notes) consumed by masked device code.
* **The mix is a matmul.** Voice→bus mixing with per-voice equal-power pan
  gains is a ``[2, V] @ [V, B]`` contraction.

Reference layer map and component inventory: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"

from libgooey_tpu.core.constants import DEFAULT_SAMPLE_RATE, DEFAULT_BLOCK_SIZE

__all__ = [
    "DEFAULT_SAMPLE_RATE",
    "DEFAULT_BLOCK_SIZE",
]
