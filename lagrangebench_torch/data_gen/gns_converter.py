"""DeepMind GNS dataset (.tfrecord) -> LagrangeBench h5 converter.

Counterpart of ``lagrangebench_tpu/data_gen/gns_converter.py`` (the
reference's data_gen/gns_data/tfrecord_to_h5.py): reads the WaterDrop-style tfrecords
(positions as serialized float32 frames, particle types per trajectory,
metadata.json with bounds/dt/radius), writes <split>.h5 groups and injects
the fields LagrangeBench needs (num_particles_max, non-periodic flags).

TensorFlow and h5py are only needed here; both imports are deferred, and
without TensorFlow the converter raises a clear ImportError.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict

import numpy as np


def _require_tf():
    try:
        import tensorflow as tf  # noqa: F401

        return tf
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "tensorflow is required to read GNS tfrecords; install it or "
            "convert on a machine that has it"
        ) from e


def _parse_serialized_simulation_example(example_proto, metadata, tf):
    """Parse one trajectory record (positions + particle types)."""
    feature_description = {
        "key": tf.io.FixedLenFeature([], tf.int64, default_value=0),
        "particle_type": tf.io.VarLenFeature(tf.string),
    }
    features = {
        "position": tf.io.VarLenFeature(tf.string),
    }
    context, parsed = tf.io.parse_single_sequence_example(
        example_proto,
        context_features=feature_description,
        sequence_features=features,
    )
    positions = tf.io.decode_raw(parsed["position"].values, tf.float32)
    positions = tf.reshape(
        positions,
        [metadata["sequence_length"] + 1, -1, metadata["dim"]],
    )
    particle_type = tf.io.decode_raw(context["particle_type"].values, tf.int64)
    particle_type = tf.reshape(particle_type, [-1])
    return positions, particle_type


def tfrecord_to_h5(dataset_dir: str, out_dir: str = None) -> str:
    """Convert {train,valid,test}.tfrecord in dataset_dir to .h5 files."""
    tf = _require_tf()
    import h5py

    out_dir = out_dir or dataset_dir
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(dataset_dir, "metadata.json"), "r") as f:
        metadata: Dict = json.loads(f.read())

    num_particles_max = 0
    for split in ("train", "valid", "test"):
        src = os.path.join(dataset_dir, f"{split}.tfrecord")
        if not os.path.exists(src):
            continue
        ds = tf.data.TFRecordDataset([src])
        ds = ds.map(
            functools.partial(
                _parse_serialized_simulation_example, metadata=metadata, tf=tf
            )
        )
        with h5py.File(os.path.join(out_dir, f"{split}.h5"), "w") as hf:
            for i, (positions, particle_type) in enumerate(ds):
                pos = np.asarray(positions)
                ptype = np.asarray(particle_type)
                num_particles_max = max(num_particles_max, pos.shape[1])
                g = hf.create_group(f"{i:05d}")
                g.create_dataset("position", data=pos)
                g.create_dataset("particle_type", data=ptype)

    # inject the LagrangeBench-required fields
    metadata["num_particles_max"] = int(num_particles_max)
    metadata["periodic_boundary_conditions"] = [False] * metadata["dim"]
    if "sequence_length" in metadata:
        metadata.setdefault(
            "sequence_length_train", metadata["sequence_length"] + 1
        )
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    return out_dir


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--out-dir", default=None)
    args = p.parse_args()
    print(tfrecord_to_h5(args.dataset_dir, args.out_dir))
