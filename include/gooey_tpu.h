/* gooey_tpu.h — C ABI for the batched JAX gooey engine.
 *
 * Behavioral reference: src/ffi.rs (the `gooey_engine_*` surface the iOS
 * host compiles against; constants at ffi.rs:1548-1970).  The native shim
 * (native/gooey_shim.cpp) embeds CPython and forwards each call to
 * libgooey_tpu.capi; compute runs through jax/XLA.
 *
 * Threading: all calls are GIL-serialized by the shim; any thread may call.
 * Errors: engine-internal failures latch the engine into silence (render
 * returns zeros forever) and are readable via gooey_engine_last_error.
 */
#ifndef GOOEY_TPU_H
#define GOOEY_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int64_t gooey_handle;

/* ---- instrument ids (ffi.rs:1843-1851) ---- */
enum {
  GOOEY_INSTRUMENT_KICK = 0,
  GOOEY_INSTRUMENT_SNARE = 1,
  GOOEY_INSTRUMENT_HIHAT = 2,
  GOOEY_INSTRUMENT_TOM = 3,
  GOOEY_INSTRUMENT_BASS = 4,
};

/* ---- kick param ids (ffi.rs:1737-1747) ---- */
enum {
  GOOEY_KICK_PARAM_FREQUENCY = 0,
  GOOEY_KICK_PARAM_PUNCH = 1,
  GOOEY_KICK_PARAM_SUB = 2,
  GOOEY_KICK_PARAM_CLICK = 3,
  GOOEY_KICK_PARAM_DECAY = 4,
  GOOEY_KICK_PARAM_PITCH_ENVELOPE = 5,
  GOOEY_KICK_PARAM_VOLUME = 6,
  GOOEY_KICK_PARAM_TUNING = 7,
};

/* ---- hihat param ids (HiHat2 family) ---- */
enum {
  GOOEY_HIHAT_PARAM_PITCH = 0,
  GOOEY_HIHAT_PARAM_DECAY = 1,
  GOOEY_HIHAT_PARAM_ATTACK = 2,
  GOOEY_HIHAT_PARAM_TONE = 3,
  GOOEY_HIHAT_PARAM_VOLUME = 4,
  GOOEY_HIHAT_PARAM_TUNING = 5,
};

/* ---- snare param ids ---- */
enum {
  GOOEY_SNARE_PARAM_FREQUENCY = 0,
  GOOEY_SNARE_PARAM_DECAY = 1,
  GOOEY_SNARE_PARAM_BRIGHTNESS = 2,
  GOOEY_SNARE_PARAM_VOLUME = 3,
  GOOEY_SNARE_PARAM_TONAL = 4,
  GOOEY_SNARE_PARAM_NOISE = 5,
  GOOEY_SNARE_PARAM_PITCH_DROP = 6,
  GOOEY_SNARE_PARAM_TONAL_DECAY = 7,
  GOOEY_SNARE_PARAM_NOISE_DECAY = 8,
  GOOEY_SNARE_PARAM_NOISE_TAIL_DECAY = 9,
  GOOEY_SNARE_PARAM_FILTER_CUTOFF = 10,
  GOOEY_SNARE_PARAM_FILTER_RESONANCE = 11,
  GOOEY_SNARE_PARAM_FILTER_TYPE = 12,
  GOOEY_SNARE_PARAM_XFADE = 13,
  GOOEY_SNARE_PARAM_PHASE_MOD_AMOUNT = 14,
  GOOEY_SNARE_PARAM_OVERDRIVE = 15,
  GOOEY_SNARE_PARAM_AMP_DECAY = 16,
  GOOEY_SNARE_PARAM_AMP_DECAY_CURVE = 17,
  GOOEY_SNARE_PARAM_TONAL_DECAY_CURVE = 18,
  GOOEY_SNARE_PARAM_TUNING = 19,
};

/* ---- tom param ids (Tom2 family) ---- */
enum {
  GOOEY_TOM_PARAM_TUNE = 0,
  GOOEY_TOM_PARAM_BEND = 1,
  GOOEY_TOM_PARAM_TONE = 2,
  GOOEY_TOM_PARAM_COLOR = 3,
  GOOEY_TOM_PARAM_DECAY = 4,
  GOOEY_TOM_PARAM_MEMBRANE = 5,
  GOOEY_TOM_PARAM_MEMBRANE_Q = 6,
  GOOEY_TOM_PARAM_VOLUME = 7,
  GOOEY_TOM_PARAM_TUNING = 8,
};

/* ---- bass param ids ---- */
enum {
  GOOEY_BASS_PARAM_FREQUENCY = 0,
  GOOEY_BASS_PARAM_SUB_LEVEL = 1,
  GOOEY_BASS_PARAM_OSC_LEVEL = 2,
  GOOEY_BASS_PARAM_DETUNE_LEVEL = 3,
  GOOEY_BASS_PARAM_DETUNE_AMOUNT = 4,
  GOOEY_BASS_PARAM_OSC_SHAPE = 5,
  GOOEY_BASS_PARAM_FILTER_CUTOFF = 6,
  GOOEY_BASS_PARAM_FILTER_RESONANCE = 7,
  GOOEY_BASS_PARAM_FILTER_ENV_AMOUNT = 8,
  GOOEY_BASS_PARAM_FILTER_ENV_DECAY = 9,
  GOOEY_BASS_PARAM_FILTER_ENV_CURVE = 10,
  GOOEY_BASS_PARAM_AMP_DECAY = 11,
  GOOEY_BASS_PARAM_AMP_DECAY_CURVE = 12,
  GOOEY_BASS_PARAM_OVERDRIVE = 13,
  GOOEY_BASS_PARAM_VOLUME = 14,
  GOOEY_BASS_PARAM_TUNING = 15,
};

/* ---- granulator param ids ---- */
enum {
  GOOEY_GRANULATOR_PARAM_SCAN_POSITION = 0,
  GOOEY_GRANULATOR_PARAM_GRAIN_LENGTH = 1,
  GOOEY_GRANULATOR_PARAM_SPRAY = 2,
  GOOEY_GRANULATOR_PARAM_PITCH = 3,
  GOOEY_GRANULATOR_PARAM_DENSITY = 4,
  GOOEY_GRANULATOR_PARAM_TEXTURE = 5,
  GOOEY_GRANULATOR_PARAM_DIRECTION = 6,
  GOOEY_GRANULATOR_PARAM_CLOUD_DURATION = 7,
  GOOEY_GRANULATOR_PARAM_VOLUME = 8,
  GOOEY_GRANULATOR_PARAM_RANDOM_TIMING = 9,
  GOOEY_GRANULATOR_PARAM_RANDOM_AMP = 10,
  GOOEY_GRANULATOR_PARAM_DRIVE = 11,
};

/* ---- global effect ids (effect_chain.rs / mixer/chain.py) ---- */
enum {
  GOOEY_EFFECT_LOWPASS_FILTER = 0,
  GOOEY_EFFECT_DELAY = 1,
  GOOEY_EFFECT_SATURATION = 2,
  GOOEY_EFFECT_COMPRESSOR = 3,
  GOOEY_EFFECT_TILT_FILTER = 4,
  GOOEY_EFFECT_LIMITER = 5,
  GOOEY_EFFECT_REVERB = 6,
  GOOEY_EFFECT_WAVESHAPER = 7,
  GOOEY_EFFECT_FEEDBACK_WAVESHAPER = 8,
  GOOEY_EFFECT_PLATE_REVERB = 9,
};

/* ---- runtime setup ---- */

/* Optional: add a directory to the embedded interpreter's module path
 * before the first gooey_engine_new (e.g. the repo checkout).  May be
 * called multiple times; no-op after initialization. */
void gooey_set_module_path(const char *path);

/* ---- engine lifecycle ---- */

/* Returns a handle > 0, or 0 on failure (see gooey_engine_last_error(0)). */
gooey_handle gooey_engine_new(double sample_rate);
void gooey_engine_free(gooey_handle h);

/* Render `frames` interleaved stereo samples into out[frames*2].
 * Returns 0 on success; on internal error fills silence and returns -1. */
int32_t gooey_engine_render(gooey_handle h, float *out, int64_t frames);

/* Copy the latched error (or "") into buf; returns its full length. */
int64_t gooey_engine_last_error(gooey_handle h, char *buf, int64_t buf_len);

/* Offline bounce into out[frames*2] (interleaved); 0 on success. */
int32_t gooey_engine_bounce_to_buffer(gooey_handle h, float *out,
                                      int64_t frames);

/* ---- buffer-loading entry points (PCM copied) ---- */
int32_t gooey_engine_granulator_load(gooey_handle h, const float *samples,
                                     int64_t count, double sample_rate);
int32_t gooey_engine_loop_load(gooey_handle h, int32_t channel,
                               const float *interleaved, int64_t frames,
                               int32_t num_channels, double sample_rate,
                               double source_bpm);
int32_t gooey_engine_loop_queue_swap(gooey_handle h, int32_t channel,
                                     const float *interleaved, int64_t frames,
                                     int32_t num_channels, double sample_rate,
                                     int32_t divisions, double source_bpm);
int32_t gooey_engine_clip_load(gooey_handle h, int32_t column, int32_t row,
                               const float *interleaved, int64_t frames,
                               int32_t num_channels, double sample_rate,
                               double source_bpm);
int32_t gooey_engine_sampler_set_slot_buffer(gooey_handle h, int32_t rack,
                                             int32_t slot,
                                             const float *interleaved,
                                             int64_t frames,
                                             int32_t num_channels,
                                             double sample_rate);

/* ---- array/string-out entry points ---- */
int64_t gooey_engine_get_error_message(gooey_handle h, char *buf,
                                       int64_t buf_len);
int32_t gooey_engine_granulator_set_buffer(gooey_handle h, const float *samples,
                                           int64_t count, double sample_rate);
void gooey_engine_free_buffer(float *ptr);
int32_t gooey_engine_set_effect_order(gooey_handle h, const int32_t *order,
                                      int64_t count);
int64_t gooey_engine_get_effect_order(gooey_handle h, int32_t *out,
                                      int64_t out_len);
int32_t gooey_engine_sequencer_set_instrument_note_pattern(
    gooey_handle h, int32_t channel, const int32_t *notes, int64_t count);
int64_t gooey_engine_drain_midi_events(gooey_handle h, int64_t *samples,
                                       int32_t *strips, double *velocities,
                                       int64_t cap);
int32_t gooey_engine_perf_get_sampler_event(gooey_handle h, int32_t index,
                                            int32_t *tick, int32_t *rack,
                                            int32_t *slot, double *velocity);
typedef void (*gooey_error_callback)(const char *message, void *user_data);
void gooey_engine_set_error_callback(gooey_handle h, gooey_error_callback cb,
                                     void *user_data);
void gooey_engine_poll_error_callback(gooey_handle h);
int64_t gooey_engine_get_channel_peaks(gooey_handle h, float *out,
                                       int64_t out_len);
int64_t gooey_engine_mixer_get_track_name(gooey_handle h, int32_t track,
                                          char *buf, int64_t buf_len);
int32_t gooey_engine_perf_get_event(gooey_handle h, int32_t index,
                                    double *out9);
int32_t gooey_engine_sampler_get_step(gooey_handle h, int32_t rack,
                                      int32_t step, int32_t *enabled,
                                      int32_t *slot, double *velocity);

#ifdef __cplusplus
} /* extern "C" */
#endif

/* The ~200 scalar wrappers (transport, typed params, strips, sequencers,
 * LFOs, FX, poly, blend pads, granulator, mixer graph, loops, clip grid,
 * sampler racks, performance recorder) are generated from the signature
 * table in native/gen_shim.py: */
#include "gooey_tpu_gen.h"

#endif /* GOOEY_TPU_H */
