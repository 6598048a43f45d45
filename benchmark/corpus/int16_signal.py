"""Sampled signals: noisy multi-channel little-endian int16.

A stand-in for the Silesia corpus's mr, x-ray and sao (Deorowicz): binary
numeric data on which the `-f1` delta and LPC filters matter.  Each
channel is a sum of sinusoids (their frequencies and amplitudes from
`layout`, the same for every seed; their phases from the seed), a slow
random walk and white noise, and the channels are interleaved sample by
sample.  Every number is a parameter of the traffic file (`params`)."""

import numpy as np


def generate(n: int, rng: np.random.Generator, layout: np.random.Generator,
             *, channels: int, tones: int, amplitude: float,
             walk_step: float, noise: float) -> np.ndarray:
    frames = -(-n // (2 * channels))
    t = np.arange(frames, dtype=np.float64)
    sig = np.empty((frames, channels))
    for c in range(channels):
        freqs = layout.uniform(1e-4, 2e-2, tones)
        amps = amplitude * layout.dirichlet(np.ones(tones))
        phases = rng.uniform(0, 2 * np.pi, tones)
        wave = (amps[:, None] * np.sin(2 * np.pi * freqs[:, None] * t
                                       + phases[:, None])).sum(0)
        walk = np.cumsum(rng.normal(0, walk_step, frames))
        sig[:, c] = wave + walk - walk.mean() + rng.normal(0, noise, frames)
    samples = np.clip(np.rint(sig), -32768, 32767).astype("<i2")
    return samples.reshape(-1).view(np.uint8)[:n].copy()
