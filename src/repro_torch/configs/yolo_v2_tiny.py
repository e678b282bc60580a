"""Tiny YOLOv2-style conv detector — the paper's own evaluation model (a copy
of ``repro.configs.yolo_v2_tiny``).

AdaOper's Fig. 2 benchmarks YOLOv2 on a Snapdragon 855. The port carries its
operator graph (``core.opgraph.build_yolo_graph``: 9 conv stages, 416x416
input, 125 output channels = 5 anchors x (20 classes + 5)), which drives the
closed-loop controller's simulator experiments, and the conv network
itself (``models.convnet``: ``init_yolo`` / ``apply_yolo``, fp32). Not
part of the assigned 10-arch pool; ``get_config("yolo-v2-tiny")``
resolves it.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yolo-v2-tiny",
    family="conv",
    source="AdaOper Fig.2 / arXiv:1612.08242",
    num_layers=9,
    d_model=416,  # input resolution (conv models reuse this slot)
    vocab_size=0,
    input_mode="image",
)

# conv stage spec: (out_channels, stride-via-maxpool)
YOLO_STAGES = [
    (16, 2), (32, 2), (64, 2), (128, 2), (256, 2), (512, 1),
    (1024, 1), (1024, 1), (125, 1),
]
