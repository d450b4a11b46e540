"""Command-line tools of the port, each run as
``python -m mm3dgs_slam_torch.scripts.<name>``: bag2data (a capture bag to
the UT-MM directory layout), concat_pose_and_twist (pose + twist streams to
Odometry), eval_traj (ATE of a results.npz, and its plot) and eval_image
(re-render a checkpoint and score it)."""
