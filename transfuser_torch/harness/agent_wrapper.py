"""(Copy of transfuser_tpu/harness/agent_wrapper.py.)

Agent sensor validation + leaderboard sensor attribute pinning.

Behavioral spec: leaderboard/autoagents/agent_wrapper_local.py:28-245 —
validate the agent's declared rig against track rules (MAP-only sensors,
id uniqueness, <=10 m extrinsics radius, per-type count limits) and pin
leaderboard-fixed attributes (lidar ranges/rotation rates, gnss/imu noise;
datagen vs eval profiles).
"""

from __future__ import annotations

import math
from typing import Dict, List

from ..agents.base import Track


class SensorConfigurationInvalid(Exception):
    pass


# Per-type count limits (agent_wrapper_local.py:28-39).
SENSOR_LIMITS = {
    "sensor.camera.rgb": 4,
    "sensor.lidar.ray_cast": 1,
    "sensor.other.radar": 2,
    "sensor.other.gnss": 1,
    "sensor.other.imu": 1,
    "sensor.opendrive_map": 1,
    "sensor.speedometer": 1,
}

MAP_ONLY_SENSORS = {"sensor.opendrive_map"}
DATAGEN_EXTRA_SENSORS = {"sensor.camera.semantic_segmentation",
                         "sensor.camera.depth"}
MAX_SENSOR_RADIUS = 10.0  # meters from ego origin

# Leaderboard-pinned sensor attributes (agent_wrapper_local.py:113-184).
LIDAR_EVAL = {"range": 85.0, "rotation_frequency": 10.0,
              "points_per_second": 600000, "dropoff_general_rate": 0.45}
LIDAR_DATAGEN = {"range": 85.0, "rotation_frequency": 20.0,
                 "points_per_second": 1200000, "dropoff_general_rate": 0.0}
GNSS_NOISE = {"noise_alt_stddev": 0.000005, "noise_lat_stddev": 0.000005,
              "noise_lon_stddev": 0.000005}
IMU_NOISE = {"noise_accel_stddev_x": 0.001, "noise_accel_stddev_y": 0.001,
             "noise_accel_stddev_z": 0.015, "noise_gyro_stddev_x": 0.001,
             "noise_gyro_stddev_y": 0.001, "noise_gyro_stddev_z": 0.002}


def validate_sensor_configuration(sensors: List[Dict], track: Track,
                                  datagen: bool = False) -> None:
    counts: Dict[str, int] = {}
    seen_ids = set()
    for spec in sensors:
        stype = spec.get("type")
        sid = spec.get("id")
        if sid in seen_ids:
            raise SensorConfigurationInvalid(
                f"Duplicated sensor tag [{sid}]")
        seen_ids.add(sid)

        if track == Track.SENSORS and stype in MAP_ONLY_SENSORS:
            raise SensorConfigurationInvalid(
                f"Illegal sensor used for Track [{track}]: {stype}")
        if not datagen and stype in DATAGEN_EXTRA_SENSORS:
            raise SensorConfigurationInvalid(
                f"Illegal sensor used: {stype} (datagen only)")

        x, y, z = (spec.get(k, 0.0) for k in ("x", "y", "z"))
        if math.sqrt(x * x + y * y + z * z) > MAX_SENSOR_RADIUS:
            raise SensorConfigurationInvalid(
                f"Sensor [{sid}] too far from the vehicle "
                f"(>{MAX_SENSOR_RADIUS} m)")

        counts[stype] = counts.get(stype, 0) + 1

    for stype, n in counts.items():
        limit = SENSOR_LIMITS.get(stype)
        if not datagen and limit is not None and n > limit:
            raise SensorConfigurationInvalid(
                f"Too many sensors of type {stype}: {n} > {limit}")


def pinned_lidar_attributes(datagen: bool) -> Dict[str, float]:
    return dict(LIDAR_DATAGEN if datagen else LIDAR_EVAL)
