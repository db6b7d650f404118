"""One rank of the port's data-parallel tests (``test_torch_dist.py``; not
collected: no ``test_`` prefix).

    python tests/torch_dist_worker.py <mode> <input.pt> <out_dir>

The rendezvous comes from the environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), as ``engine.launch`` sets it, and the ranks join
over gloo through ``parallel.dist.init``, on the CPU or, with
``GEOT_DIST_DEVICE=cuda``, on the card. Modes:

- ``step``: build the semi state from the input's converted weights, take
  this rank's block of each global batch and run the semi step on it;
  after each step save the metrics and the whole state to
  ``<out_dir>/rank<r>_step<i>.pt``. Before the first step, save the
  training-mode forward of the rank's labelled block gathered into the
  global batch, and the BatchNorm running statistics it left
  (``rank<r>_bn.pt``).
- ``seed``: seed numpy's global generator with ``100 + rank`` (so the
  ranks' own draws differ), then draw the run seed as the trainer does;
  save it to ``rank<r>_seed.json``.
"""
import json
import os
import sys


def _block(batch, rank, world, device):
    return {k: v[rank * (v.shape[0] // world):
                 (rank + 1) * (v.shape[0] // world)].to(device)
            for k, v in batch.items()}


def _cpu(tree):
    """``tree``'s tensors copied to the host."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def main():
    mode, in_path, out_dir = sys.argv[1:4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from geot_tpu_torch.parallel import dist

    device = os.environ.get("GEOT_DIST_DEVICE", "cpu")
    assert dist.init(None, device)
    rank, world = dist.rank(), dist.world()
    device = dist.rank_device(device)
    if mode == "seed":
        from geot_tpu_torch.engine.train import _draw_seed

        np.random.seed(100 + rank)
        seed = _draw_seed("cpu")
        with open(os.path.join(out_dir, f"rank{rank}_seed.json"), "w") as f:
            json.dump({"seed": seed, "initialized": dist.is_initialized()},
                      f)
        dist.shutdown()
        return

    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    data = torch.load(in_path, weights_only=False)
    cfg = data["cfg"]
    state = SemiTrainState.create(cfg, seg_args=data["seg_args"],
                                  device=device)
    state.load(data["state"])

    # the training forward of this rank's labelled block, then the BN
    # statistics it leaves; the state is restored before the steps
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    bl = _block(data["batches"][0][0], rank, world, device)
    state.model.train()
    with torch.no_grad():
        logits = dist.gather(state.model(bl)[0])
    torch.save(_cpu({"logits": logits,
                     "buffers": {k: v for k, v in
                                 state.model.state_dict().items()
                                 if "running" in k}}),
               os.path.join(out_dir, f"rank{rank}_bn.pt"))
    state.model.load_state_dict(saved)

    step = make_semi_step(cfg)
    for i, (bl, bu) in enumerate(data["batches"]):
        metrics = step(state, _block(bl, rank, world, device),
                       _block(bu, rank, world, device), data["lr"], True)
        torch.save(_cpu({
            "metrics": metrics, "model": state.model.state_dict(),
            "t_predictor": state.t_predictor.state_dict(),
            "ema_t": state.ema_t, "contrast": state.contrast.queue,
            "exp_avg": {n: state.opt.state[p]["exp_avg"]
                        for n, p in state.model.named_parameters()}}),
            os.path.join(out_dir, f"rank{rank}_step{i}.pt"))
    dist.shutdown()


if __name__ == "__main__":
    main()
