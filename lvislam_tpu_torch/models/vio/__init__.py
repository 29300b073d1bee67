"""Visual-inertial odometry models (port of ``lvislam_tpu.models.vio``)."""
