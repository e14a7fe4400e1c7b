"""The port stands alone: nothing under src/repro_torch/ and not
chip_smoke.py imports `jax` or the JAX package `repro`, importing the port
leaves jax out of sys.modules, and its entry points refuse to run without
a device when no CUDA is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch.core.pipeline, repro_torch.launch.serve, "
            "repro_torch.kernels.segment_reduce.ops, repro_torch.convert, "
            "repro_torch.nn.attention, repro_torch.nn.transformer, "
            "repro_torch.configs, repro_torch.configs.mistral_nemo_12b, "
            "repro_torch.configs.d3gnn_sage, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.embedding_bag.ops, "
            "repro_torch.kernels.embedding_bag.ref, repro_torch.recsys, "
            "repro_torch.recsys.embedding_bag, repro_torch.recsys.two_tower, "
            "repro_torch.configs.two_tower_retrieval, "
            "repro_torch.dist.router, repro_torch.dist.wire, "
            "repro_torch.dist.mesh, "
            "repro_torch.launch.mesh, repro_torch.kernels.route_pack.ops, "
            "repro_torch.kernels.route_pack.ref, "
            "repro_torch.serve.query, repro_torch.serve.session, "
            "repro_torch.data.streams, repro_torch.core.explosion, "
            "repro_torch.core.train_plane, repro_torch.core.training, "
            "repro_torch.serve.train_session, repro_torch.optim, "
            "repro_torch.optim.quantized, repro_torch.dist.grad_compression, "
            "repro_torch.core.aggregators, repro_torch.ft.chaos, "
            "repro_torch.ft.elastic, repro_torch.ft.checkpoint, "
            "repro_torch.launch.train, repro_torch.nn.module, "
            "repro_torch.configs.base, repro_torch.graph.segment, "
            "repro_torch.graph.gat, repro_torch.graph.pna, "
            "repro_torch.graph.gatedgcn, repro_torch.graph.mp, "
            "repro_torch.graph.so3, repro_torch.graph.nequip, "
            "repro_torch.graph.dimenet, repro_torch.graph.triplets, "
            "repro_torch.graph.sampler, repro_torch.nn.initializers, "
            "repro_torch.configs.gnn_common, repro_torch.configs.pna, "
            "repro_torch.configs.gatedgcn, repro_torch.configs.dimenet, "
            "repro_torch.configs.nequip, repro_torch.nn.moe, "
            "repro_torch.dist.moe_ep, repro_torch.dist.gnn_locality, "
            "repro_torch.configs.moonshot_v1_16b_a3b, "
            "repro_torch.configs.llama4_maverick_400b_a17b, "
            "repro_torch.configs.internlm2_20b, "
            "repro_torch.configs.mistral_large_123b, "
            "repro_torch.launch.dryrun, repro_torch.dist.sharding, "
            "repro_torch.dist.dry_mesh, repro_torch.roofline.op_analyzer, "
            "repro_torch.roofline.analysis, repro_torch.roofline.report, "
            "repro_torch.roofline.model_flops, repro_torch.perf.run, "
            "repro_torch.perf.variants, repro_torch.work, "
            "repro_torch.examples, repro_torch.examples.quickstart, "
            "repro_torch.examples.streaming_serve, "
            "repro_torch.examples.train_streaming_gnn, "
            "repro_torch.examples.arch_zoo; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("quickstart", ["--stage", "2"]),
    ("streaming_serve", ["--edges", "10"]),
    ("streaming_serve", ["--edges", "10", "--ranks", "4"]),
    ("train_streaming_gnn", []),
    ("train_streaming_gnn", ["--mode", "halt-flush"]),
    ("arch_zoo", ["--arch", "pna"])])
def test_examples_raise_without_cuda(monkeypatch, name, argv):
    """The examples' CLIs run on the card unless --device names another;
    the mesh forms refuse before they start a rank."""
    from importlib import import_module
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_module(f"repro_torch.examples.{name}").main(argv)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.core.pipeline import D3Pipeline, PipelineConfig
    from repro_torch.graph.sage import GraphSAGE
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PipelineConfig(n_parts=2, node_cap=8, edge_cap=8, repl_cap=8,
                         feat_cap=8, edge_tick_cap=8, max_nodes=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D3Pipeline(GraphSAGE((4, 4)), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--edges", "10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mistral-nemo-12b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mistral-nemo-12b", "--reduced"])
    spec = get_arch("mistral-nemo-12b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.step(spec.build_reduced(), "prefill_32k")
    for arch in ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
                 "internlm2-20b", "mistral-large-123b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch, "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "two-tower-retrieval"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "two-tower-retrieval", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_arch("two-tower-retrieval").build_reduced()
    from repro_torch.launch import train
    for arch, shape in (("mistral-nemo-12b", "train_4k"),
                        ("two-tower-retrieval", "train_batch"),
                        ("gatedgcn", "full_graph_sm"),
                        ("nequip", "molecule")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", arch, "--shape", shape, "--reduced"])
    for arch in ("pna", "gatedgcn", "dimenet", "nequip"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_arch(arch).build_reduced()
    # a mesh rank with no device named: CUDA, never the CPU unasked
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_stream_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_stream_mesh()
        assert make_stream_mesh("cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_kernel_build_needs_no_nvcc_at_import():
    """Importing the kernel modules builds nothing and looks for no nvcc:
    the build directory is only touched at first CUDA launch."""
    from repro_torch.kernels import cuda_lib
    assert cuda_lib._LOADED == {}
    assert (cuda_lib.CSRC / "segment_reduce.cu").exists()
    assert (cuda_lib.CSRC / "flash_attention.cu").exists()
    assert (cuda_lib.CSRC / "embedding_bag.cu").exists()
    assert (cuda_lib.CSRC / "route_pack.cu").exists()
