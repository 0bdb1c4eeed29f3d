"""(Copy of transfuser_tpu/agents/bridge_agent.py; its ROS node is named transfuser_torch_bridge.)

External-stack bridge agent (reference ros_agent.py equivalent).

The reference ``RosAgent`` (leaderboard/autoagents/ros_agent.py:40-451)
publishes each sensor frame on carla-ros-bridge-style topics, publishes
the global plan once, stamps a clock, and returns the last
``vehicle_control_cmd`` received from the external driving stack —
optionally blocking until a fresh command arrives ("stepping mode").

This port keeps that contract but makes the transport pluggable:

  * ``LocalBus`` — an in-process pub/sub bus. Lets any Python driving
    stack (or a test) attach to the same topic surface without ROS, and
    keeps the closed-loop harness hermetic.
  * ``RosBus`` — thin adapter over ``rospy`` with the carla-ros-bridge
    topic names; only constructed when rospy is importable, so the
    module imports cleanly in ROS-less environments.

Messages are plain dicts with numpy payloads; a ROS stack sees them
converted by RosBus, an in-process stack consumes them directly.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..sim.types import VehicleControl
from .base import AutonomousAgent, Track

EGO = "/carla/ego_vehicle"
CONTROL_TOPIC = f"{EGO}/vehicle_control_cmd"
CLOCK_TOPIC = "/clock"
PLAN_TOPIC = f"{EGO}/waypoints"
STATUS_TOPIC = f"{EGO}/vehicle_status"


class LocalBus:
    """In-process pub/sub with latched last-value semantics per topic."""

    def __init__(self) -> None:
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}
        self._latched: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def publish(self, topic: str, msg: Any) -> None:
        with self._lock:
            self._latched[topic] = msg
            subs = list(self._subs.get(topic, ()))
        for cb in subs:
            cb(msg)

    def subscribe(self, topic: str, cb: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs.setdefault(topic, []).append(cb)
            latched = self._latched.get(topic)
        if latched is not None:
            cb(latched)

    def last(self, topic: str) -> Any:
        with self._lock:
            return self._latched.get(topic)

    def close(self) -> None:
        with self._lock:
            self._subs.clear()


class RosBus:
    """rospy-backed bus with carla-ros-bridge topic names.

    Constructed lazily; raises ImportError where rospy is unavailable
    (the LocalBus covers ROS-less deployments and tests).
    """

    def __init__(self, node_name: str = "transfuser_torch_bridge") -> None:
        import rospy  # noqa: F401 — hard dependency of this transport
        self._rospy = rospy
        rospy.init_node(node_name, anonymous=True, disable_signals=True)
        self._pubs: Dict[str, Any] = {}

    def publish(self, topic: str, msg: Any) -> None:
        from std_msgs.msg import String
        pub = self._pubs.get(topic)
        if pub is None:
            pub = self._rospy.Publisher(topic, String, queue_size=10,
                                        latch=True)
            self._pubs[topic] = pub
        import json

        def default(o):
            tolist = getattr(o, "tolist", None)
            return tolist() if tolist else str(o)

        pub.publish(String(json.dumps(msg, default=default)))

    def subscribe(self, topic: str, cb: Callable[[Any], None]) -> None:
        from std_msgs.msg import String
        import json
        self._rospy.Subscriber(topic, String,
                               lambda m: cb(json.loads(m.data)))

    def close(self) -> None:
        for pub in self._pubs.values():
            pub.unregister()
        self._pubs.clear()


class BridgeAgent(AutonomousAgent):
    """Publishes the sensor surface to a bus, drives from bus controls.

    Parity with ros_agent.py: clock per tick (:415), plan published once
    (:421-424), per-sensor topics (:428-443), stepping-mode wait for a
    fresh control (:445-448), last-received control returned otherwise.
    """

    #: seconds to wait for a control in stepping mode before giving up
    control_timeout: float = 10.0

    def setup(self, path_to_conf_file: str = "",
              route_index: Optional[int] = None) -> None:
        self.track = Track.SENSORS
        self.stepping = False
        self.bus = self.make_bus(path_to_conf_file)
        self.current_control = VehicleControl()
        self._control_event = threading.Event()
        self._plan_published = False
        self._step_mode_possible = False
        self.bus.subscribe(CONTROL_TOPIC, self._on_control)

    # Override point: tests and in-process stacks inject a LocalBus.
    def make_bus(self, path_to_conf_file: str):
        try:
            return RosBus()
        except ImportError:
            return LocalBus()

    def _on_control(self, msg: Any) -> None:
        c = VehicleControl()
        for k in ("throttle", "steer", "brake", "hand_brake", "reverse"):
            if isinstance(msg, dict) and k in msg:
                setattr(c, k, msg[k])
            elif hasattr(msg, k):
                setattr(c, k, getattr(msg, k))
        self.current_control = c
        self._control_event.set()
        # after the first command the stack is known to be listening
        self._step_mode_possible = True

    def sensors(self) -> List[Dict[str, Any]]:
        return [
            {"type": "sensor.camera.rgb", "id": "rgb", "x": 1.3, "y": 0.0,
             "z": 2.3, "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
             "width": 960, "height": 480, "fov": 120},
            {"type": "sensor.lidar.ray_cast", "id": "lidar", "x": 1.3,
             "y": 0.0, "z": 2.5, "roll": 0.0, "pitch": 0.0, "yaw": -90.0},
            {"type": "sensor.other.imu", "id": "imu", "x": 0.0, "y": 0.0,
             "z": 0.0, "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
             "sensor_tick": 0.05},
            {"type": "sensor.other.gnss", "id": "gps", "x": 0.0, "y": 0.0,
             "z": 0.0, "sensor_tick": 0.01},
            {"type": "sensor.speedometer", "id": "speed",
             "reading_frequency": 20},
        ]

    def _topic_for(self, sensor_id: str) -> str:
        if not hasattr(self, "_sensor_types"):
            self._sensor_types = {s["id"]: s["type"]
                                  for s in self.sensors()}
        spec = self._sensor_types.get(sensor_id, "")
        if spec.startswith("sensor.camera"):
            return f"{EGO}/camera/rgb/{sensor_id}/image"
        if spec.startswith("sensor.lidar"):
            return f"{EGO}/lidar/{sensor_id}/point_cloud"
        if spec == "sensor.other.gnss":
            return f"{EGO}/gnss/{sensor_id}/fix"
        if spec == "sensor.other.imu":
            return f"{EGO}/imu/{sensor_id}"
        if spec == "sensor.speedometer":
            return STATUS_TOPIC
        return f"{EGO}/{sensor_id}"

    def run_step(self, input_data: Dict[str, Any],
                 timestamp: float) -> VehicleControl:
        self._control_event.clear()
        self.bus.publish(CLOCK_TOPIC, {"clock": timestamp})

        if self._global_plan_world_coord and not self._plan_published:
            self._plan_published = True
            self.bus.publish(PLAN_TOPIC, {
                "poses": [{"x": tf.location.x, "y": tf.location.y,
                           "yaw": tf.rotation.yaw}
                          for tf, _opt in self._global_plan_world_coord]})

        fresh = False
        for sensor_id, (_frame_no, data) in input_data.items():
            fresh = True
            self.bus.publish(self._topic_for(sensor_id), {
                "id": sensor_id, "stamp": timestamp, "data": data})

        if self.stepping and self._step_mode_possible and fresh:
            if not self._control_event.wait(self.control_timeout):
                raise RuntimeError(
                    f"stack sent no control within "
                    f"{self.control_timeout:.0f}s (stepping mode)")
        return self.current_control

    def destroy(self) -> None:
        self.bus.close()
