"""Progressive accumulation framebuffer — port of
``tpurt.render.framebuffer``.

``FrameState`` holds the running radiance sum on the device plus host
counters: the sample count (also the next global sample index, the RNG
stream position) and the next batch index.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FrameState(NamedTuple):
    accum: torch.Tensor  # (H, W, 3) f32 — running *sum* of radiance samples
    n_samples: int  # samples accumulated per pixel (RNG stream position)
    seed: int  # base seed of the counter-based RNG
    batch_index: int  # next progressive batch id

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]


def new_frame_state(width: int, height: int, seed: int = 0,
                    device="cpu") -> FrameState:
    return FrameState(
        accum=torch.zeros((height, width, 3), dtype=torch.float32,
                          device=device),
        n_samples=0,
        seed=int(seed),
        batch_index=0,
    )


def accumulate(state: FrameState, radiance_sum: torch.Tensor,
               samples_added: int) -> FrameState:
    """Fold one rendered sample batch into the running accumulation."""
    return state._replace(
        accum=state.accum + radiance_sum,
        n_samples=int(state.n_samples) + int(samples_added),
        batch_index=int(state.batch_index) + 1,
    )


def resolve(state: FrameState) -> torch.Tensor:
    """Mean radiance image (H, W, 3) f32 linear."""
    return state.accum / float(max(int(state.n_samples), 1))


def tonemap(linear: torch.Tensor, exposure: float = 1.0,
            gamma: float = 2.2) -> torch.Tensor:
    """Clamp + gamma tonemap → display-space f32 in [0, 1]."""
    x = torch.clamp(linear * exposure, 0.0, 1.0)
    return x ** (1.0 / gamma)


def pack_u8(display: torch.Tensor) -> torch.Tensor:
    """Display-space f32 [0,1] → uint8 with round-half-away."""
    return torch.clamp(display * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def to_png_array(state: FrameState, exposure: float = 1.0) -> np.ndarray:
    """Host readback: resolve → tonemap → uint8 numpy."""
    return pack_u8(tonemap(resolve(state), exposure)).cpu().numpy()
