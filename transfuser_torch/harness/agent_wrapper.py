"""(Copy of transfuser_tpu/harness/agent_wrapper.py: the pinned noise profiles and lidar attributes.)

Leaderboard sensor attribute pinning.

Behavioral spec: leaderboard/autoagents/agent_wrapper_local.py:113-184 —
leaderboard-fixed attributes (lidar ranges/rotation rates, gnss/imu
noise) of the evaluation profile.
"""

# Leaderboard-pinned sensor attributes (agent_wrapper_local.py:113-184).
LIDAR_EVAL = {"range": 85.0, "rotation_frequency": 10.0,
              "points_per_second": 600000, "dropoff_general_rate": 0.45}
GNSS_NOISE = {"noise_alt_stddev": 0.000005, "noise_lat_stddev": 0.000005,
              "noise_lon_stddev": 0.000005}
IMU_NOISE = {"noise_accel_stddev_x": 0.001, "noise_accel_stddev_y": 0.001,
             "noise_accel_stddev_z": 0.015, "noise_gyro_stddev_x": 0.001,
             "noise_gyro_stddev_y": 0.001, "noise_gyro_stddev_z": 0.002}
