"""(Copy of transfuser_tpu/harness/sensor_interface.py.)

Sensor gather barrier: callbacks from (real or replay) sensors funnel
into a queue; get_data blocks until every registered sensor delivered the
current frame.

Behavioral spec: leaderboard/envs/sensor_interface.py:198-243 (queue
barrier, 10 s timeout -> SensorReceivedNoData, opendrive-map exemption) and
the threaded pseudo-sensor readers (:16-88).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


class SensorConfigurationInvalid(Exception):
    pass


class SensorReceivedNoData(Exception):
    pass


class _LazyEntry:
    """Deferred sensor payload: materializes on first access."""
    __slots__ = ("frame", "fn")

    def __init__(self, frame: int, fn: Callable[[], Any]):
        self.frame = frame
        self.fn = fn


class LazySensorData(dict):
    """get_data() view whose expensive entries (camera renders, lidar
    synthesis) materialize on first access — an agent that only reads
    them every Nth tick (the DataAgent saves at 2 Hz against a 20 Hz
    sim) never pays for the other N-1 synths. Same idiom as
    sim.replay._LazyFrame.

    Consume via indexing / get / items / values (what agents do).
    copy()/dict(...)/pickle materialize everything first; bypassing
    that with e.g. ``{**d}`` would leak raw _LazyEntry objects."""

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if type(v) is _LazyEntry:
            v = (v.frame, v.fn())
            dict.__setitem__(self, key, v)
        return v

    def get(self, key, default=None):
        return self[key] if dict.__contains__(self, key) else default

    def items(self):
        return [(k, self[k]) for k in dict.keys(self)]

    def values(self):
        return [self[k] for k in dict.keys(self)]

    def _materialize(self) -> None:
        for k in dict.keys(self):
            self[k]

    def copy(self):
        self._materialize()
        return LazySensorData(dict.items(self))

    def __reduce__(self):  # pickle/deepcopy see only real payloads
        self._materialize()
        return (LazySensorData, (dict(dict.items(self)),))


class SensorInterface:
    def __init__(self, timeout: float = 10.0):
        self._sensors: Dict[str, Any] = {}
        self._queue: "queue.Queue" = queue.Queue()
        self._timeout = timeout
        self._opendrive_tag: Optional[str] = None

    # --------------------------------------------------------- registration
    def register_sensor(self, tag: str, sensor_type: str,
                        sensor: Any = None) -> None:
        if tag in self._sensors:
            raise SensorConfigurationInvalid(f"duplicated sensor tag [{tag}]")
        self._sensors[tag] = sensor
        if sensor_type == "sensor.opendrive_map":
            self._opendrive_tag = tag

    # ------------------------------------------------------------ callbacks
    def update_sensor(self, tag: str, data: Any, frame: int,
                      lazy: bool = False) -> None:
        """lazy=True: `data` is a zero-arg callable evaluated on the
        agent's first access to this tag (get_data still counts the
        delivery against the frame barrier immediately)."""
        if tag not in self._sensors:
            raise SensorConfigurationInvalid(f"sensor [{tag}] not registered")
        self._queue.put((tag, frame, data, lazy))

    # -------------------------------------------------------------- barrier
    def get_data(self) -> Dict[str, Tuple[int, Any]]:
        data_dict: Dict[str, Tuple[int, Any]] = LazySensorData()
        deadline = time.monotonic() + self._timeout
        while len(data_dict) < len(self._sensors):
            # OpenDRIVE pseudo-sensor may legitimately deliver nothing.
            if self._opendrive_tag and self._opendrive_tag not in data_dict \
                    and len(self._sensors) == len(data_dict) + 1:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise SensorReceivedNoData(
                    "A sensor took too long to send its data")
            try:
                tag, frame, data, lazy = self._queue.get(timeout=remaining)
            except queue.Empty:
                raise SensorReceivedNoData(
                    "A sensor took too long to send its data")
            data_dict[tag] = _LazyEntry(frame, data) if lazy \
                else (frame, data)
        return data_dict


class BaseReader(threading.Thread):
    """Daemon thread producing pseudo-sensor readings at a fixed rate
    (speedometer, opendrive map)."""

    def __init__(self, tag: str, interface: SensorInterface,
                 read_fn: Callable[[], Any], period: float):
        super().__init__(daemon=True)
        self._tag = tag
        self._interface = interface
        self._read_fn = read_fn
        self._period = period
        self._running = True
        self._frame = 0

    def run(self) -> None:
        while self._running:
            data = self._read_fn()
            if data is not None:
                self._interface.update_sensor(self._tag, data, self._frame)
                self._frame += 1
            time.sleep(self._period)

    def stop(self) -> None:
        self._running = False
