"""Merge VRPN pose + twist streams into Odometry, offline, no ROS.

    python -m mm3dgs_slam_torch.scripts.concat_pose_and_twist in.bag out.bag \
        [--pose-topic /vrpn_client_node/Jackal_Latest/pose] \
        [--twist-topic /vrpn_client_node/Jackal_Latest/twist] \
        [--odom-topic /vrpn_client_node/Jackal_Latest/odom] [--txt]

Offline counterpart of the reference's live node
UT_MM_Scripts/concat_pose_and_twist.py (a rospy subscriber that republishes
each PoseStamped as a nav_msgs/Odometry carrying the latest TwistStamped
seen so far), and the port's copy of the JAX package's script. It applies
the same latest-twist-wins merge to a recorded bag and writes the merged
Odometry stream into a new bag (or, with --txt, a TUM-style
"stamp tx ty tz qx qy qz qw vx vy vz wx wy wz" text file), with the
pure-Python bag codec in mm3dgs_slam_torch.data.rosbag1.
"""
import argparse

from ..data.rosbag1 import BagReader, BagWriter

POSE_TOPIC = "/vrpn_client_node/Jackal_Latest/pose"
TWIST_TOPIC = "/vrpn_client_node/Jackal_Latest/twist"
ODOM_TOPIC = "/vrpn_client_node/Jackal_Latest/odom"


def merge(bag: BagReader, pose_topic: str = POSE_TOPIC,
          twist_topic: str = TWIST_TOPIC):
    """Yield (time, header, pose, twist_or_None) per pose message, with the
    reference's latest-twist-wins pairing (callback_pose reads the global
    set by callback_twist: concat_pose_and_twist.py:12-25). Messages are
    replayed in record-time order, matching live arrival order."""
    latest_twist = None
    for topic, msg, t in bag.read_messages([pose_topic, twist_topic]):
        if topic == twist_topic:
            latest_twist = msg.twist
        else:
            yield t, msg.header, msg.pose, latest_twist


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("in_bag")
    p.add_argument("out")
    p.add_argument("--pose-topic", default=POSE_TOPIC)
    p.add_argument("--twist-topic", default=TWIST_TOPIC)
    p.add_argument("--odom-topic", default=ODOM_TOPIC)
    p.add_argument("--txt", action="store_true",
                   help="write a text table instead of a bag")
    args = p.parse_args()

    bag = BagReader(args.in_bag)
    n = 0
    if args.txt:
        with open(args.out, "w") as f:
            f.write("# stamp tx ty tz qx qy qz qw vx vy vz wx wy wz\n")
            for t, header, pose, twist in merge(bag, args.pose_topic,
                                                args.twist_topic):
                pp, q = pose.position, pose.orientation
                if twist is None:
                    v = w = type("z", (), {"x": 0.0, "y": 0.0, "z": 0.0})()
                else:
                    v, w = twist.linear, twist.angular
                f.write(
                    f"{header.stamp.secs}.{header.stamp.nsecs:09d} "
                    f"{pp.x} {pp.y} {pp.z} {q.x} {q.y} {q.z} {q.w} "
                    f"{v.x} {v.y} {v.z} {w.x} {w.y} {w.z}\n")
                n += 1
    else:
        with BagWriter(args.out) as out:
            out.add_connection(args.odom_topic, "nav_msgs/Odometry")
            for t, header, pose, twist in merge(bag, args.pose_topic,
                                                args.twist_topic):
                out.write(args.odom_topic, {
                    "header": {"seq": header.seq, "stamp": header.stamp,
                               "frame_id": header.frame_id},
                    "pose": {"pose": pose},
                    "twist": {"twist": twist} if twist is not None else {},
                }, t)
                n += 1
    print(f"merged {n} poses -> {args.out}")


if __name__ == "__main__":
    main()
