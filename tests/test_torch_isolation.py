"""(f) The port imports neither ``jax`` nor ``repro``; (g) its entry points
refuse to run without CUDA unless ``device="cpu"`` is asked for, and its
kernel wrappers never fall back to the plain version for a CUDA tensor."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import bitpack, build, count_sketch, ops, qsgd, \
    ternary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import pkgutil, sys, importlib\n"
        "import repro_torch, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.configs.shapes\n"
        "import repro_torch.optim.sgd, repro_torch.optim.adamw\n"
        "import repro_torch.core.aggregation, repro_torch.core.federated\n"
        "import repro_torch.core.hierarchical, repro_torch.core.gossip\n"
        "import repro_torch.launch.mesh, repro_torch.models.sharding\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "             or m.startswith(('jax.', 'repro.', 'jaxlib')))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every module was imported


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.core.types import FLConfig
    from repro_torch.data.synthetic import FedDataConfig, sample_round
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.models.model import Model
    model = Model(get_arch("paper_lm"))
    fl = FLConfig(uplink_compressor="topk:0.05>>qsgd:8", backend="kernel")
    for call in (lambda: make_sim_step(model, fl, 2),
                 lambda: model.init(0),
                 lambda: sample_round(FedDataConfig(256, 2, 8, 1), 0),
                 lambda: train.main(["--rounds", "1"]),
                 lambda: model.init_cache(2, 16),
                 lambda: serve.main(["--steps", "1"]),
                 lambda: init_ranks("gloo", None, 0, 2,
                                    "tcp://127.0.0.1:1"),
                 lambda: train.main(["--nproc", "2", "--dist-backend",
                                     "gloo"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    sim = make_sim_step(model, fl, 2, device="cpu")
    assert sim.engine.device.type == "cpu"


def test_unported_knobs_raise_naming_the_reference_module():
    """The star (with or without a population), hier and gossip topologies
    are ported, on a model axis too (their tests are in
    test_torch_topology.py, test_torch_mesh_population.py,
    test_torch_model_axis.py and test_torch_mesh_model_axis.py), and the
    CLI's ``--model-parallel`` defaults to the reference's 2; what stays
    out raises naming its module: pod-level clients and FSDP's data-axis
    dims."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import Topology, make_round_engine
    from repro_torch.core.population import ClientPopulation
    from repro_torch.core.types import FLConfig
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    model = Model(get_arch("paper_lm"))
    fsdp = Model(dataclasses.replace(get_arch("paper_lm"), fsdp=True))
    fl = FLConfig(uplink_compressor="qsgd:8")
    data4 = M.Mesh(shape={"data": 4, "model": 1}, rank=0,
                   device=torch.device("cpu"), backend="gloo", groups={})
    pods = M.Mesh(shape={"pod": 2, "data": 2, "model": 1}, rank=0,
                  device=torch.device("cpu"), backend="gloo", groups={})
    model2 = M.Mesh(shape={"pod": 2, "data": 1, "model": 2}, rank=0,
                    device=torch.device("cpu"), backend="gloo", groups={})
    data2 = M.Mesh(shape={"pod": 2, "data": 2, "model": 2}, rank=0,
                   device=torch.device("cpu"), backend="gloo", groups={})
    pop = ClientPopulation(n_clients=100, cohort=4)
    assert make_round_engine(model, fl, Topology.star(), mesh=data4,
                             population=pop).aux["population"] == pop
    for topo in (Topology.hier(2), Topology.gossip()):
        eng = make_round_engine(model, fl, topo, mesh=model2)
        assert eng.n_clients == (2 if topo.kind == "hier" else 1)
    assert train._parse([]).model_parallel == 2
    for call, module in (
            (lambda: make_round_engine(model, fl, Topology.star("pod"),
                                       mesh=pods), "repro.models.sharding"),
            (lambda: make_round_engine(fsdp, fl, Topology.hier(2),
                                       mesh=data2), "repro.models.sharding"),
            (lambda: make_round_engine(fsdp, fl, Topology.gossip(),
                                       mesh=data2), "repro.models.sharding")):
        with pytest.raises(NotImplementedError, match=module):
            call()


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without one: it passes the
    wrappers' argument checks, so what follows is the kernel path."""

    def __init__(self, n):
        self.device = torch.device("cuda")
        self.dtype = torch.float32
        self.shape = (n,)

    def dim(self):
        return 1

    def numel(self):
        return self.shape[0]

    def is_contiguous(self):
        return True

    def reshape(self, *_):
        return self

    def contiguous(self):
        return self


def test_kernel_wrappers_raise_on_cuda_tensor_without_a_build(monkeypatch,
                                                              tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_FUNCS", {})
    x, one = _FakeCuda(3001), _FakeCuda(1)
    before = dict(build.LAUNCHES)
    for call in (lambda: ops.threshold_sparsify(x, one),
                 lambda: ops.qsgd_quantize(x, x, 8, 2048),
                 lambda: ops.qsgd_quantize_packed(x, x, 4, 2048),
                 lambda: ternary.ternarize_cuda(x, one),
                 lambda: bitpack.ternarize_pack_cuda(x, one),
                 lambda: ops.sketch(x, 5, 4096)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert dict(build.LAUNCHES) == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.qsgd_quantize(torch.zeros(4, device="meta"),
                          torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        qsgd.qsgd_quantize_cuda(torch.zeros(4), torch.zeros(4))
    for cuda_only in (lambda: ternary.ternarize_cuda(torch.zeros(4),
                                                     torch.zeros(1)),
                      lambda: bitpack.pack_codes_cuda(
                          torch.zeros((1, 8), dtype=torch.int8)),
                      lambda: bitpack.unpack_codes_cuda(
                          torch.zeros((1, 2), dtype=torch.uint8)),
                      lambda: count_sketch.count_sketch_cuda(
                          torch.zeros(4), [3], [0], 1, 8)):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_only()
