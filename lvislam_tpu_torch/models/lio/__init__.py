"""LiDAR-inertial odometry and mapping (counterpart of ``lvislam_tpu.models.lio``)."""
