"""Command-line tools of the port, each run as
``python -m mm3dgs_slam_torch.scripts.<name>``: bag2data (a capture bag to
the UT-MM directory layout), concat_pose_and_twist (pose + twist streams to
Odometry), eval_traj (ATE of a results.npz, and its plot), eval_image
(re-render a checkpoint and score it), run_golden (a golden run, optionally
on a shipped scene and with the per-frame wall decomposition), diff_results
(two runs' metrics, trajectory and map against the 1% thresholds),
visualizer (offline or interactive views of a saved map), train_tiny_dpt
(fit the TinyDPT depth estimator), fit_niqe_model (a NIQE pristine model)
and imu_preintegrate (offline IMU dead-reckoning to the reference's CSV). The bench is ``python -m mm3dgs_slam_torch.bench``."""
