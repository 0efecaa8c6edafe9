"""Checkpoint / resume of progressive renders — port of
``tpurt.render.checkpoint``.

The whole render state is the ``FrameState`` (radiance sum, sample count,
RNG seed, batch cursor), so a checkpoint is one ``.npz`` and resuming is
loading it and continuing the batch loop. The RNG is counter-based (a
function of seed, sample index and pixel), so a resumed render draws the
same sample stream and ends bit-identical to an uninterrupted one. The
file layout (keys, ``_FORMAT_VERSION``, ``config_json``) is the
reference's: a checkpoint of either package opens in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpurt_torch.render import framebuffer as fb
from tpurt_torch.scene.device import torch_device
from tpurt_torch.utils.config import RenderConfig

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: fb.FrameState,
                    config: RenderConfig | None = None,
                    camera=None) -> None:
    """Serialize a FrameState (and optionally its config and camera) to
    .npz."""
    arrays = {
        "version": np.asarray(_FORMAT_VERSION, np.int32),
        "accum": state.accum.detach().cpu().numpy(),
        "n_samples": np.asarray(int(state.n_samples)),
        "seed": np.asarray(int(state.seed)),
        "batch_index": np.asarray(int(state.batch_index)),
    }
    if config is not None:
        arrays["config_json"] = np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), np.uint8)
    if camera is not None:
        arrays["cam_position"] = np.asarray(camera.position)
        arrays["cam_look_at"] = np.asarray(camera.look_at)
        arrays["cam_up"] = np.asarray(camera.up)
        arrays["cam_vfov_deg"] = np.asarray(camera.vfov_deg)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, device="cuda"):
    """Returns (FrameState with its sum on ``device`` — the card unless the
    caller asks for the CPU —, config or None, Camera or None)."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format v{version} != supported "
                f"v{_FORMAT_VERSION}")
        state = fb.FrameState(
            accum=torch.from_numpy(np.array(z["accum"])).to(
                torch_device(device)),
            n_samples=int(z["n_samples"]),
            seed=int(z["seed"]),
            batch_index=int(z["batch_index"]),
        )
        config = None
        if "config_json" in z:
            raw = json.loads(z["config_json"].tobytes().decode())
            # JSON has no tuple: restore the tuple-typed fields (live_caps)
            # so the loaded config compares equal to the saved one
            raw = {k: tuple(v) if isinstance(v, list) else v
                   for k, v in raw.items()}
            config = RenderConfig(**raw)
        camera = None
        if "cam_position" in z:
            from tpurt_torch.core.camera import Camera

            camera = Camera.make(z["cam_position"], z["cam_look_at"],
                                 z["cam_up"], float(z["cam_vfov_deg"]))
    return state, config, camera
