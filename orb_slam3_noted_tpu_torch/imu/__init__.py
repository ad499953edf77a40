"""IMU preintegration (port of :mod:`orb_slam3_noted_tpu.imu`)."""
