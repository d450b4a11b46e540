"""ROS1 bag -> UT-MM capture-format dataset directory, no ROS required.

    python -m mm3dgs_slam_torch.scripts.bag2data --path <bag dir> --scene <name>

Offline counterpart of the reference's scripts/bag2data.py (which imports
rosbag/cv_bridge/tf and therefore only runs on a ROS1 machine), and the
port's copy of the JAX package's: the bag is read with the pure-Python
parser in mm3dgs_slam_torch.data.rosbag1, images are decoded and written
with cv2, and the output follows the reference's contract
(bag2data.py:24-159):

    <path>/<scene>/intrinsics.txt    "# ..." header + "<stamp> <K tuple>"
    <path>/<scene>/tf.txt            microstrain_link -> realsense_color_frame
    <path>/<scene>/groundtruth.txt   "<stamp> tx ty tz qx qy qz qw"
    <path>/<scene>/rgb/NNNNNN.png    bottom 60 px cropped (bag2data.py:95)
    <path>/<scene>/rgb.txt           "<stamp> rgb/NNNNNN.png"
    <path>/<scene>/depth/NNNNNN.png  uint16, bottom 60 px cropped (:119)
    <path>/<scene>/depth.txt
    <path>/<scene>/imu.txt           38 columns: stamp + orientation(4) +
                                     3x3 cov + ang_vel(3) + 3x3 cov +
                                     lin_accel(3) + 3x3 cov (:133-158);
                                     the SLAM loaders read ang_vel at
                                     value-cols [13:16] and lin_accel at
                                     [25:28] (data/utmm.py)

Timestamps use the reference's "{secs}.{nsecs:09d}" formatting and images
are numbered sequentially ("{i:06d}.png"). The tf.txt transform is resolved
offline from the bag's /tf_static (and /tf) topics instead of a live
tf.TransformListener.
"""
import argparse
import os
import sys
from glob import glob

import numpy as np

from ..data.rosbag1 import BagReader, lookup_static_transform

TOPICS = {
    "camera_info": "/realsense/color/camera_info",
    "rgb": "/realsense/color/image_raw/compressed",
    "depth": "/realsense/depth/image_rect_raw",
    "imu": "/microstrain/imu/data",
    "gt": "/vrpn_client_node/Jackal_Latest/pose",
}
TF_SOURCE = "realsense_color_frame"
TF_TARGET = "microstrain_link"
CROP_BOTTOM = 60


def _stamp(msg) -> str:
    return f"{msg.header.stamp.secs}.{msg.header.stamp.nsecs:09d}"


def _rows(msg, bytes_per_pixel: int) -> bytes:
    """Raw Image payload with any row stride (msg.step) collapsed to
    contiguous w*bytes_per_pixel rows — cv_bridge honors step, so bags
    from drivers that pad rows must keep converting here too."""
    h, w = int(msg.height), int(msg.width)
    buf = np.frombuffer(np.asarray(msg.data, dtype=np.uint8), np.uint8)
    step = int(getattr(msg, "step", 0)) or w * bytes_per_pixel
    if step == w * bytes_per_pixel:
        return buf.tobytes()
    return buf.reshape(h, step)[:, : w * bytes_per_pixel].tobytes()


def _decode_color(msg) -> np.ndarray:
    """CompressedImage (jpeg/png payload) or raw Image -> BGR uint8 (the
    reference goes through cv_bridge with desired_encoding='bgr8')."""
    import cv2

    if msg._type == "sensor_msgs/CompressedImage":
        arr = np.frombuffer(np.asarray(msg.data, dtype=np.uint8), np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"undecodable compressed image ({msg.format})")
        return img
    enc = msg.encoding.lower()
    h, w = int(msg.height), int(msg.width)
    if enc in ("bgr8", "rgb8"):
        img = np.frombuffer(_rows(msg, 3), np.uint8).reshape(h, w, 3)
        return img[:, :, ::-1].copy() if enc == "rgb8" else img.copy()
    if enc == "bgra8":
        return np.frombuffer(_rows(msg, 4), np.uint8).reshape(
            h, w, 4)[:, :, :3].copy()
    if enc == "mono8":
        m = np.frombuffer(_rows(msg, 1), np.uint8).reshape(h, w, 1)
        return np.repeat(m, 3, axis=2)
    raise ValueError(f"unsupported color encoding {enc!r}")


def _decode_depth(msg) -> np.ndarray:
    """Raw depth Image -> uint16 (mm), matching bag2data.py:115-121."""
    h, w = int(msg.height), int(msg.width)
    enc = msg.encoding.lower()
    if enc in ("16uc1", "mono16"):
        dt = ">u2" if msg.is_bigendian else "<u2"
        return np.frombuffer(_rows(msg, 2), dtype=dt).reshape(
            h, w).astype(np.uint16)
    if enc == "32fc1":
        dt = ">f4" if msg.is_bigendian else "<f4"
        m = np.frombuffer(_rows(msg, 4), dtype=dt).reshape(h, w)
        return np.nan_to_num(m * 1000.0).clip(0, 65535).astype(np.uint16)
    raise ValueError(f"unsupported depth encoding {enc!r}")


def convert(bag_path: str, out_dir: str, topics=None, tf_target=TF_TARGET,
            tf_source=TF_SOURCE, crop_bottom: int = CROP_BOTTOM):
    import cv2

    topics = {**TOPICS, **(topics or {})}
    bag = BagReader(bag_path)
    print("Topics in the bag file:")
    for t in bag.topics:
        print(t)
    scene = os.path.basename(os.path.normpath(out_dir))
    rgb_path = os.path.join(out_dir, "rgb")
    depth_path = os.path.join(out_dir, "depth")
    os.makedirs(rgb_path, exist_ok=True)
    os.makedirs(depth_path, exist_ok=True)

    print("Reading camera intrinsics")
    with open(os.path.join(out_dir, "intrinsics.txt"), "w") as f:
        f.write("# camera intrinsics\n")
        f.write(f"# file: {scene}.bag\n")
        f.write("# timestamp K\n")
        for _, msg, _ in bag.read_messages([topics["camera_info"]]):
            f.write(f"{_stamp(msg)} {tuple(float(k) for k in msg.K)}\n")

    print("Reading transformations")
    with open(os.path.join(out_dir, "tf.txt"), "w") as f:
        f.write("# transformations\n")
        f.write(f"# file: {scene}.bag\n")
        f.write("# tx ty tz qx qy qz qw\n")
        f.write(f"# {tf_target} to {tf_source}\n")
        try:
            t, q = lookup_static_transform(bag, tf_target, tf_source)
            f.write(f"{t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
        except KeyError as e:
            print(f"WARNING: {e}; tf.txt left without a transform line")

    print("Reading GT trajectory")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n")
        f.write(f"# file: {scene}.bag\n")
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for _, msg, _ in bag.read_messages([topics["gt"]]):
            pose = msg.pose
            if hasattr(pose, "pose"):     # nav_msgs/Odometry
                pose = pose.pose
            t, q = pose.position, pose.orientation
            f.write(f"{_stamp(msg)} {t.x} {t.y} {t.z} "
                    f"{q.x} {q.y} {q.z} {q.w}\n")

    print("Reading image files")
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("# color images\n")
        f.write(f"# file: {scene}.bag\n")
        f.write("# timestamp filename\n")
        for i, (_, msg, _) in enumerate(
                bag.read_messages([topics["rgb"]])):
            image = _decode_color(msg)
            if crop_bottom:
                image = image[:-crop_bottom, :]
            cv2.imwrite(os.path.join(rgb_path, f"{i:06d}.png"), image)
            f.write(f"{_stamp(msg)} rgb/{i:06d}.png\n")

    print("Reading depth files")
    with open(os.path.join(out_dir, "depth.txt"), "w") as f:
        f.write("# depth images\n")
        f.write(f"# file: {scene}.bag\n")
        f.write("# timestamp filename\n")
        for i, (_, msg, _) in enumerate(
                bag.read_messages([topics["depth"]])):
            image = _decode_depth(msg)
            if crop_bottom:
                image = image[:-crop_bottom, :]
            cv2.imwrite(os.path.join(depth_path, f"{i:06d}.png"), image)
            f.write(f"{_stamp(msg)} depth/{i:06d}.png\n")

    print("Reading imu files")
    with open(os.path.join(out_dir, "imu.txt"), "w") as f:
        f.write("# imu measurements\n")
        f.write(f"# file: {scene}.bag\n")
        f.write(
            "# timestamp ori_x ori_y ori_z ori_w "
            "ori_cov1 ori_cov2 ori_cov3 ori_cov4 ori_cov5 ori_cov6 "
            "ori_cov7 ori_cov8 ori_cov9 "
            "ang_x ang_y ang_z "
            "ang_cov1 ang_cov2 ang_cov3 ang_cov4 ang_cov5 ang_cov6 "
            "ang_cov7 ang_cov8 ang_cov9 "
            "acc_x acc_y acc_z "
            "acc_cov1 acc_cov2 acc_cov3 acc_cov4 acc_cov5 acc_cov6 "
            "acc_cov7 acc_cov8 acc_cov9\n")
        for _, msg, _ in bag.read_messages([topics["imu"]]):
            o, a, l = msg.orientation, msg.angular_velocity, \
                msg.linear_acceleration
            oc = [float(v) for v in msg.orientation_covariance]
            ac = [float(v) for v in msg.angular_velocity_covariance]
            lc = [float(v) for v in msg.linear_acceleration_covariance]
            vals = ([o.x, o.y, o.z, o.w] + oc + [a.x, a.y, a.z] + ac
                    + [l.x, l.y, l.z] + lc)
            f.write(f"{_stamp(msg)} " + " ".join(str(v) for v in vals)
                    + "\n")
    print(f"Wrote {out_dir}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", type=str, required=True,
                        help="Path to rosbag directory.")
    parser.add_argument("--scene", type=str, required=True,
                        help="Name of scene (subdirectory with the .bag).")
    for key, default in TOPICS.items():
        parser.add_argument(f"--{key}-topic", default=default,
                            dest=f"{key}_topic")
    parser.add_argument("--tf-target", default=TF_TARGET)
    parser.add_argument("--tf-source", default=TF_SOURCE)
    parser.add_argument("--crop-bottom", type=int, default=CROP_BOTTOM)
    parser.add_argument("--bag", type=str, default=None,
                        help="Explicit .bag file (required when the scene "
                             "directory holds more than one).")
    args = parser.parse_args()

    if args.bag:
        bag = args.bag
    else:
        bags = sorted(glob(os.path.join(args.path, args.scene, "*.bag")))
        if not bags:
            sys.exit(f"no .bag file under {args.path}/{args.scene}")
        if len(bags) > 1:
            sys.exit("multiple .bag files under "
                     f"{args.path}/{args.scene}: {bags}; pick one with "
                     "--bag")
        bag = bags[0]
    convert(bag, os.path.join(args.path, args.scene),
            topics={k: getattr(args, f"{k}_topic") for k in TOPICS},
            tf_target=args.tf_target, tf_source=args.tf_source,
            crop_bottom=args.crop_bottom)


if __name__ == "__main__":
    main()
