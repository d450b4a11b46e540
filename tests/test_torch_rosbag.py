"""The port's ROS1 bag codec (mm3dgs_slam_torch/data/rosbag1.py) and its
bag tools (mm3dgs_slam_torch/scripts/bag2data.py, concat_pose_and_twist.py)
against the JAX package's: bags written by either package read back by the
other, byte-equal bags for the same messages, and the converted UT-MM
directory file by file."""
import os
import sys

import numpy as np
import pytest

from mm3dgs_slam_tpu.data import rosbag1 as jrb
from mm3dgs_slam_torch.data import rosbag1 as trb

from test_rosbag import _write_capture_bag

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

IMU = "sensor_msgs/Imu"
ODOM = "nav_msgs/Odometry"


def _messages():
    """(topic, type, message, time) of a small mixed stream."""
    out = []
    for i in range(30):
        t = 50.0 + 0.01 * i
        out.append(("/imu", IMU, {
            "header": {"seq": i, "stamp": t, "frame_id": "imu"},
            "orientation": {"w": 1.0},
            "angular_velocity": {"x": 0.0, "y": -0.01 * i, "z": 0.1 * i},
            "linear_acceleration": {"x": 1.0, "y": -9.80665, "z": 0.001 * i},
            "orientation_covariance": np.full(9, 0.5),
        }, t))
        if i % 3 == 0:
            out.append(("/odom", ODOM, {
                "header": {"seq": i, "stamp": t + 0.001, "frame_id": "odom"},
                "child_frame_id": "base_link",
                "pose": {"pose": {"position": {"x": 0.1 * i, "y": -2.0, "z": 0.25},
                                  "orientation": {"z": 0.7071068, "w": 0.7071068}},
                         "covariance": np.arange(36.0)},
                "twist": {"twist": {"linear": {"x": 0.4}, "angular": {"z": -0.1}},
                          "covariance": np.zeros(36)},
            }, t + 0.001))
    return out


def _write(rb, path, compression):
    with rb.BagWriter(path, chunk_threshold=1500, compression=compression) as w:
        w.add_connection("/imu", IMU)
        w.add_connection("/odom", ODOM)
        for topic, _, msg, t in _messages():
            w.write(topic, msg, t)


def _flat(m):
    """A decoded message as nested plain values, for comparison."""
    if isinstance(m, (jrb.Msg, trb.Msg)):
        return {k: _flat(v) for k, v in vars(m).items()}
    if isinstance(m, (jrb.RosTime, trb.RosTime)):
        return (m.secs, m.nsecs)
    if isinstance(m, np.ndarray):
        return m.tolist()
    if isinstance(m, (list, tuple)):
        return [_flat(v) for v in m]
    return m


def _read(rb, path):
    bag = rb.BagReader(path)
    return bag.topics, [(topic, _flat(m), (t.secs, t.nsecs))
                        for topic, m, t in bag.read_messages()]


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_bag_written_by_one_package_reads_in_the_other(tmp_path, compression, writer, reader):
    pkgs = {"jax": jrb, "torch": trb}
    path = str(tmp_path / "t.bag")
    _write(pkgs[writer], path, compression)
    topics, got = _read(pkgs[reader], path)
    _, want = _read(pkgs[writer], path)
    assert topics == {"/imu": IMU, "/odom": ODOM}
    assert got == want
    assert len(got) == 40
    assert [m[2] for m in got] == sorted(m[2] for m in got)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_bytes_equal_for_the_same_messages(tmp_path, compression):
    _write(jrb, str(tmp_path / "jax.bag"), compression)
    _write(trb, str(tmp_path / "torch.bag"), compression)
    assert (tmp_path / "torch.bag").read_bytes() == (tmp_path / "jax.bag").read_bytes()


def test_codec_helpers_match_jax():
    """Message encoding, the full definitions and the quaternion helpers."""
    for _, mtype, msg, _ in _messages()[:4]:
        assert trb.full_definition(mtype) == jrb.full_definition(mtype)
        defn = trb.full_definition(mtype)
        assert trb.encode_message(mtype, defn, msg) == jrb.encode_message(mtype, defn, msg)
    q = (0.1, -0.2, 0.3, 0.9273618495495703)
    np.testing.assert_array_equal(trb.quat_to_matrix(*q), jrb.quat_to_matrix(*q))
    R = jrb.quat_to_matrix(*q)
    assert trb.matrix_to_quat(R) == jrb.matrix_to_quat(R)


def test_bag2data_matches_jax_file_by_file(tmp_path):
    """The port's bag2data.convert against the JAX package's on
    tests/test_rosbag.py's capture bag: every file of the UT-MM directory
    byte-equal, and the result readable by the port's UT-MM loader."""
    import bag2data as jb2d

    from mm3dgs_slam_torch.data import get_dataset_type
    from mm3dgs_slam_torch.scripts import bag2data as tb2d

    bag = str(tmp_path / "seq.bag")
    _write_capture_bag(bag, n_frames=4, h=48, w=64)
    dirs = {}
    for name, mod in (("jax", jb2d), ("torch", tb2d)):
        out = tmp_path / name / "seq"
        out.mkdir(parents=True)
        mod.convert(bag, str(out), crop_bottom=8)
        dirs[name] = out
    files = sorted(p.relative_to(dirs["jax"]) for p in dirs["jax"].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(dirs["torch"]) for p in dirs["torch"].rglob("*")
                           if p.is_file())
    assert len(files) == 14     # 6 text files, 4 colour and 4 depth PNGs
    for rel in files:
        assert (dirs["torch"] / rel).read_bytes() == (dirs["jax"] / rel).read_bytes(), rel
    cfg = {"dataset": "utmm",
           "cam": {"image_height": 40, "image_width": 64, "fx": 50.0, "fy": 50.0, "cx": 32.0,
                   "cy": 20.0, "png_depth_scale": 1000.0, "crop_edge": 0}}
    ds = get_dataset_type("utmm")(cfg, str(tmp_path / "torch"), "seq", desired_height=40,
                                  desired_width=64)
    assert len(ds) >= 3 and ds[1][4].shape[1] == 37


def test_concat_pose_and_twist_matches_jax(tmp_path):
    """The latest-twist-wins merge, on the port's codec, against the JAX
    package's script, and its --txt and bag outputs byte-equal."""
    import concat_pose_and_twist as jcpt

    from mm3dgs_slam_torch.scripts import concat_pose_and_twist as tcpt

    src = str(tmp_path / "pt.bag")
    with trb.BagWriter(src) as w:
        w.add_connection(tcpt.POSE_TOPIC, "geometry_msgs/PoseStamped")
        w.add_connection(tcpt.TWIST_TOPIC, "geometry_msgs/TwistStamped")
        for i in range(5):
            t = 10.0 + i * 0.1
            if i > 0:
                w.write(tcpt.TWIST_TOPIC, {"header": {"stamp": t - 0.05},
                                           "twist": {"linear": {"x": 1.0 * i}}}, t - 0.05)
            w.write(tcpt.POSE_TOPIC, {"header": {"seq": i, "stamp": t, "frame_id": "world"},
                                      "pose": {"position": {"x": 0.1 * i},
                                               "orientation": {"w": 1.0}}}, t)
    got = [_flat(x) for x in tcpt.merge(trb.BagReader(src))]
    want = [_flat(x) for x in jcpt.merge(jrb.BagReader(src))]
    assert got == want and len(got) == 5
    assert got[0][3] is None and got[3][3]["linear"]["x"] == 3.0
    for extra in ([], ["--txt"]):
        outs = {}
        for name, mod in (("jax", jcpt), ("torch", tcpt)):
            out = str(tmp_path / f"{name}{'.txt' if extra else '.bag'}")
            argv = sys.argv
            sys.argv = ["concat_pose_and_twist", src, out, *extra]
            try:
                mod.main()
            finally:
                sys.argv = argv
            outs[name] = open(out, "rb").read()
        assert outs["torch"] == outs["jax"]
