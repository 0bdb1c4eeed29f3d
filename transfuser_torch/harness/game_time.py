"""(Copy of transfuser_tpu/harness/game_time.py.)

Simulation-time singleton (reference srunner timer.py:17-82).

Tracks game time from world ticks plus the wall-clock time of the last
tick; the harness uses it for duration bookkeeping and the watchdogs."""

from __future__ import annotations

import time


class GameTime:
    _current_game_time = 0.0
    _carla_time = 0.0
    _last_frame = 0
    _platform_timestamp = 0.0
    _init = False

    @staticmethod
    def on_carla_tick(frame: int, elapsed_seconds: float) -> None:
        if frame > GameTime._last_frame:
            GameTime._carla_time = elapsed_seconds
            GameTime._current_game_time = elapsed_seconds
            GameTime._last_frame = frame
            GameTime._platform_timestamp = time.time()
            GameTime._init = True

    @staticmethod
    def restart() -> None:
        GameTime._current_game_time = 0.0
        GameTime._carla_time = 0.0
        GameTime._last_frame = 0
        GameTime._init = False

    @staticmethod
    def get_time() -> float:
        return GameTime._current_game_time

    @staticmethod
    def get_carla_time() -> float:
        return GameTime._carla_time

    @staticmethod
    def get_frame() -> int:
        return GameTime._last_frame

    @staticmethod
    def get_platform_time() -> float:
        return GameTime._platform_timestamp
