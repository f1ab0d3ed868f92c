"""Closed-loop batched synthesis through ``make_predict_fn``'s ``predict``: the
driver of the mixes whose generator is ``traffic/synthesis.py``."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from port_bench import check
from port_bench.harness import Cell, Reservoir, Span, program_network, seeded_weights, sync

# requests kept for the check besides the one with the most frames
KEPT = {"batched": 2, "single": 8}


class Driver:
    def __init__(self, cell: Cell, seed: int, device):
        from self_attention_tacotron_torch.synthesis import make_predict_fn

        self.cell, self.device = cell, device
        self.flat = seeded_weights(cell, seed, device)
        self.hp, self.net = program_network(cell, self.flat, device)
        self.predict = make_predict_fn(self.net, device=device)
        self.requests = cell.generator.requests(cell.traffic, seed)
        self.r = self.hp.outputs_per_step
        batch = int(cell.traffic["batch"])
        self.kept = Reservoir(KEPT["single" if batch == 1 else "batched"], seed)

    def serve(self, i: int) -> Dict:
        inputs = self.requests.request(i)
        batch = inputs["source"].shape[0]
        enc_seed, dec_seed = self.requests.encoder_seed(i), self.requests.decoder_seed(i)
        masks = check.decoder_masks(self.cell.hp, dec_seed, batch, self.device)
        gen = torch.Generator(device=self.device).manual_seed(enc_seed)
        out = self.predict(inputs, gen, masks)
        lengths = out["lengths"].cpu().numpy()
        sync(self.device)
        steps = -(-lengths // self.r)
        return {"inputs": inputs, "out": out, "encoder_seed": enc_seed, "decoder_seed": dec_seed,
                "frames": int(lengths.sum()),
                "lanes": list(zip(inputs["source_lengths"].tolist(), steps.tolist()))}

    def keep(self, item: Dict) -> None:
        self.kept.offer(item)

    def warm_up(self) -> int:
        """Serve one whole cycle of the mix (every padded source length and output
        size the window will see: the convolutions' plans are made, and the
        allocator's blocks taken, per shape); the window starts again at 0."""
        for i in range(self.requests.cycle()):
            self.serve(i)
        return 0

    def samples(self, after: int, count: int) -> Dict[str, List[float]]:
        """What the per-layer readers take besides the trace, timed after it."""
        return {"encode_ms": self.encode_ms(count),
                "postnet_ms": self.postnet_ms(self.kept.sample()[:count])}

    def encode_ms(self, count: int) -> List[float]:
        """Host milliseconds of ``TacotronNetwork.encode`` on the cell's requests,
        each ending in ``synchronize()``."""
        out = []
        for i in range(count):
            inputs = self.requests.request(i)
            gen = torch.Generator(device=self.device).manual_seed(self.requests.encoder_seed(i))
            with torch.inference_mode():
                source = torch.as_tensor(inputs["source"]).to(self.device)
                lengths = torch.as_tensor(inputs["source_lengths"]).to(self.device)
                sync(self.device)
                start = time.perf_counter()
                self.net.encode(source, lengths, generator=gen)
                sync(self.device)
            out.append(1e3 * (time.perf_counter() - start))
        return out

    def postnet_ms(self, items: List[Dict]) -> List[float]:
        """Device milliseconds (CUDA events) of ``TacotronNetwork.postnet_apply``
        on served requests' decoded mel; empty without postnets."""
        if not (self.hp.use_postnet_v2 or self.hp.use_linear_spectrogram_postnet):
            return []
        out = []
        for item in items:
            span = Span(self.device)
            with torch.inference_mode():
                self.net.postnet_apply(item["out"]["mel"], item["out"]["lengths"])
            span("postnets")
            out.append(span.ms()["postnets"])
        return out

    def release(self) -> None:
        del self.predict, self.net

    def readings(self, control: bool) -> Dict:
        return check.synthesis_readings(self.cell.reference, self.cell.hp, self.flat,
                                        self.kept.sample(), self.device, control=control)
