"""ctypes binding for the native batched Overcooked oracle.

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/native.py``,
its counterpart: the code is that file's, line for line, except where the
library goes.  It builds ``build/native/libovercooked_oracle.so`` (``build/``
is ignored by git) from the repository's ``native/overcooked_oracle.cpp`` on
first use if missing, with g++, and never writes into ``native/``
(``tests/test_torch_oracles.py`` compares the two).  Exposes the same
per-batch protocol as the simulator: ``reset() -> obs [B, P, S*C]``,
``step(actions [B, P]) -> (obs, rewards [B], dones [B])`` with in-step
auto-reset.  Used to diff the simulators against the sequential rules at
batch sizes the python oracle cannot reach.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "build", "native")
_LIB_PATH = os.path.abspath(os.path.join(_BUILD_DIR, "libovercooked_oracle.so"))
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    src = os.path.join(_NATIVE_DIR, "overcooked_oracle.cpp")
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
         "-o", _LIB_PATH, src],
        check=True,
        capture_output=True,
    )


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ovc_create_batch.restype = ctypes.c_void_p
    lib.ovc_create_batch.argtypes = [
        ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ovc_destroy.argtypes = [ctypes.c_void_p]
    lib.ovc_reset_batch.argtypes = [ctypes.c_void_p, i8p]
    lib.ovc_step_batch.argtypes = [ctypes.c_void_p, i32p, i8p, i32p, u8p]
    _lib = lib
    return lib


def _i32(a):
    return np.ascontiguousarray(np.asarray(a, np.int32))


class NativeOvercookedOracle:
    def __init__(self, variant: str, params: dict, batch: int):
        lib = _load()
        self.variant = variant
        self.H = int(params["height"])
        self.W = int(params["width"])
        self.P = int(params["num_players"])
        self.S = self.H * self.W
        self.K = 16 if variant == "v1" else 10
        self.C = 5 * self.P + self.K
        self.batch = batch

        terr = _i32(params["terrain"])
        starts = _i32(
            [int(y) * self.W + int(x)
             for x, y in zip(params["start_player_x"], params["start_player_y"])]
        )
        vals = _i32(params["recipe_values"])
        times = _i32(params["recipe_times"])
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        self._h = lib.ovc_create_batch(
            1 if variant == "v1" else 2,
            terr.ctypes.data_as(c_i32p), self.H, self.W, self.P,
            starts.ctypes.data_as(c_i32p),
            int(params["placement_in_pot_rew"]), int(params["dish_pickup_rew"]),
            int(params["soup_pickup_rew"]),
            vals.ctypes.data_as(c_i32p), times.ctypes.data_as(c_i32p),
            int(params["horizon"]), batch,
        )
        self._lib = lib

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ovc_destroy(self._h)
            self._h = None

    def reset(self) -> np.ndarray:
        obs = np.empty((self.batch, self.P, self.S * self.C), np.int8)
        self._lib.ovc_reset_batch(
            self._h, obs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        )
        return obs

    def step(self, actions: np.ndarray):
        """actions [B, P] int32 -> (obs [B, P, S*C] int8, rewards [B] int32,
        dones [B] bool); done games auto-reset."""
        a = np.ascontiguousarray(actions, np.int32)
        obs = np.empty((self.batch, self.P, self.S * self.C), np.int8)
        rew = np.empty((self.batch,), np.int32)
        done = np.empty((self.batch,), np.uint8)
        self._lib.ovc_step_batch(
            self._h,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            rew.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            done.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return obs, rew, done.astype(bool)
