"""Layer tables (im2col GEMM shapes) for the paper's five CNN workloads on
CIFAR-100 (32x32 inputs), batch 1: VGG19, ResNet18, MobileNetV2, AlexNet,
EfficientNetB0. Feeds the DB-PIM performance model (Fig. 10-13, Tab. II/III).

Port of ``repro.configs.paper_cnns``: plain data, the same tables, built
from the port's own ``LayerGEMM``.
"""

from __future__ import annotations

from typing import List

from repro_torch.core.pim_model import LayerGEMM


def _conv(name, h, w, k, cin, cout, stride=1, kind="std"):
    ho, wo = h // stride, w // stride
    return LayerGEMM(name, M=ho * wo, K=k * k * cin, N=cout, kind=kind), ho, wo


def vgg19() -> List[LayerGEMM]:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
    layers, h, cin, i = [], 32, 3, 0
    for c in cfg:
        if c == "M":
            h //= 2
            continue
        l, h, _ = _conv(f"conv{i}", h, h, 3, cin, c)
        layers.append(l)
        cin, i = c, i + 1
    layers.append(LayerGEMM("fc", M=1, K=512, N=100, kind="fc"))
    return layers


def resnet18() -> List[LayerGEMM]:
    layers, h = [], 32
    l, h, _ = _conv("stem", 32, 32, 3, 3, 64)
    layers.append(l)
    cin = 64
    for stage, (cout, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
        for blk in range(2):
            s = stride if blk == 0 else 1
            l, h, _ = _conv(f"s{stage}b{blk}c0", h, h, 3, cin, cout, s)
            layers.append(l)
            l, h, _ = _conv(f"s{stage}b{blk}c1", h, h, 3, cout, cout, 1)
            layers.append(l)
            if s != 1 or cin != cout:
                layers.append(LayerGEMM(f"s{stage}b{blk}ds", M=h * h,
                                        K=cin, N=cout, kind="pw"))
            cin = cout
    layers.append(LayerGEMM("fc", M=1, K=512, N=100, kind="fc"))
    return layers


def _inverted_residual(layers, name, h, cin, cout, t, stride):
    hid = cin * t
    if t != 1:
        layers.append(LayerGEMM(f"{name}.expand", M=h * h, K=cin, N=hid,
                                kind="pw"))
    ho = h // stride
    layers.append(LayerGEMM(f"{name}.dw", M=ho * ho, K=9, N=hid, kind="dw"))
    layers.append(LayerGEMM(f"{name}.project", M=ho * ho, K=hid, N=cout,
                            kind="pw"))
    return ho


def mobilenet_v2() -> List[LayerGEMM]:
    table = [(1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    layers, h = [], 32
    l, h, _ = _conv("stem", 32, 32, 3, 3, 32)
    layers.append(l)
    cin, i = 32, 0
    for t, c, n, s in table:
        for j in range(n):
            h = _inverted_residual(layers, f"ir{i}", h, cin, c,
                                   t, s if j == 0 else 1)
            cin, i = c, i + 1
    layers.append(LayerGEMM("head", M=h * h, K=cin, N=1280, kind="pw"))
    layers.append(LayerGEMM("fc", M=1, K=1280, N=100, kind="fc"))
    return layers


def alexnet() -> List[LayerGEMM]:
    layers = []
    specs = [("c0", 32, 3, 3, 64, 1), ("c1", 16, 3, 64, 192, 1),
             ("c2", 8, 3, 192, 384, 1), ("c3", 8, 3, 384, 256, 1),
             ("c4", 8, 3, 256, 256, 1)]
    for name, h, k, cin, cout, s in specs:
        l, _, _ = _conv(name, h, h, k, cin, cout, s)
        layers.append(l)
    layers += [LayerGEMM("fc0", M=1, K=256 * 4 * 4, N=4096, kind="fc"),
               LayerGEMM("fc1", M=1, K=4096, N=4096, kind="fc"),
               LayerGEMM("fc2", M=1, K=4096, N=100, kind="fc")]
    return layers


def efficientnet_b0() -> List[LayerGEMM]:
    table = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 40, 2, 2), (6, 80, 3, 2),
             (6, 112, 3, 1), (6, 192, 4, 2), (6, 320, 1, 1)]
    layers, h = [], 32
    l, h, _ = _conv("stem", 32, 32, 3, 3, 32)
    layers.append(l)
    cin, i = 32, 0
    for t, c, n, s in table:
        for j in range(n):
            h = _inverted_residual(layers, f"mb{i}", h, cin, c,
                                   t, s if j == 0 else 1)
            cin, i = c, i + 1
    layers.append(LayerGEMM("head", M=h * h, K=cin, N=1280, kind="pw"))
    layers.append(LayerGEMM("fc", M=1, K=1280, N=100, kind="fc"))
    return layers


CNN_MODELS = {
    "alexnet": alexnet,
    "vgg19": vgg19,
    "resnet18": resnet18,
    "mobilenetv2": mobilenet_v2,
    "efficientnetb0": efficientnet_b0,
}


#: DB-PIM kernel-mode -> cost-model feature flags (core.pim_model
#: evaluate_model). The same mode vocabulary the LM configs use
#: (ModelConfig.dbpim_mode), so paper CNNs select joint/value/bit too.
MODE_FLAGS = {
    "dense": dict(use_value=False, use_weight_bit=False, use_input_bit=False),
    "value": dict(use_value=True, use_weight_bit=False, use_input_bit=False),
    "bit": dict(use_value=False, use_weight_bit=True, use_input_bit=True),
    "joint": dict(use_value=True, use_weight_bit=True, use_input_bit=True),
}


def _round_up(v: int, q: int) -> int:
    return -(-v // q) * q


def joint_bench_shapes(max_m: int = 256):
    """Representative paper layer GEMMs for the kernel benchmark.

    Picks the largest conv (std/pw — dw convs are excluded from DB-PIM
    in the paper too) of each of the five CNNs plus AlexNet's fc1, rounds
    dims up to the 128 kernel tile and caps M (batch-1 im2col rows) at
    ``max_m``.
    """
    shapes = []
    for model in CNN_MODELS:
        layers = CNN_MODELS[model]()
        biggest = max((l for l in layers if l.kind not in ("dw", "fc")),
                      key=lambda l: l.K * l.N)
        shapes.append((f"{model}.{biggest.name}",
                       min(_round_up(biggest.M, 128), max_m),
                       _round_up(biggest.K, 128), _round_up(biggest.N, 128)))
    fc = alexnet()[-2]
    shapes.append(("alexnet.fc1", 128,
                   _round_up(fc.K, 128), _round_up(fc.N, 128)))
    return shapes
