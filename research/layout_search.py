"""Search residual entropy-layout variants against libjxl-generated
streams with a pixel oracle."""

import itertools
import sys
import os

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/research")
os.environ["JXL_NO_NATIVE"] = "1"

import numpy as np

import jxl_coder.entropy.coder as EC
from jxl_coder.bitstream.reader import BitReader, BitstreamError
from jxl_coder.entropy.prefix import read_prefix_code
from jxl_coder.entropy import ans as _ans
from jxl_coder.entropy.ans import AliasTable, AnsState


VARIANTS = dict(
    cmap_pol=("norm", "inv"),
    cfg_pos=("before_sizes", "after_sizes"),
    alpha_code=("bool_n", "plain_n"),
)

CURRENT = {}


def read_cluster_map_v(br, num_contexts):
    if num_contexts == 1:
        return [0]
    bit = br.bool()
    simple = bit if CURRENT["cmap_pol"] == "norm" else not bit
    if simple:
        nbits = br.u(2)
        cmap = [br.u(nbits) for _ in range(num_contexts)]
    else:
        use_mtf = br.bool()
        nested = EntropyDecoderV(br, 1)
        cmap = [nested.read(0) for _ in range(num_contexts)]
        if not nested.check_final_state():
            raise BitstreamError("cmap checksum")
        if use_mtf:
            mtf = list(range(256))
            out = []
            for v in cmap:
                if v > 255:
                    raise BitstreamError("mtf range")
                val = mtf[v]
                out.append(val)
                mtf.pop(v)
                mtf.insert(0, val)
            cmap = out
    ncl = max(cmap) + 1
    if sorted(set(cmap)) != list(range(ncl)):
        raise BitstreamError("cmap not dense")
    return cmap


def read_alpha_size(br):
    if CURRENT["alpha_code"] == "bool_n":
        if br.bool():
            n = br.u(4)
            return 1 + (1 << n) + br.u(n)
        return 1
    n = br.u(4)
    return 1 + (1 << n) + br.u(n)


class EntropyDecoderV(EC.EntropyDecoder):
    def __init__(self, br, num_contexts, dist_multiplier=0):
        self.br = br
        self.dist_multiplier = dist_multiplier
        self.lz77 = EC.Lz77Params.read(br)
        num_dists = num_contexts
        if self.lz77.enabled:
            num_dists += 1
            self.dist_ctx = num_contexts
            self.window = []
        self.cluster_map = read_cluster_map_v(br, num_dists)
        num_clusters = max(self.cluster_map) + 1
        self.use_prefix = br.bool()
        log_alpha = 15 if self.use_prefix else br.u(2) + 5
        self.log_alpha = log_alpha
        self.prefix_codes = []
        self.alias_tables = []
        if self.use_prefix:
            if CURRENT["cfg_pos"] == "before_sizes":
                self.configs = [EC.HybridUintConfig.read(br, log_alpha)
                                for _ in range(num_clusters)]
                sizes = [read_alpha_size(br) for _ in range(num_clusters)]
            else:
                sizes = [read_alpha_size(br) for _ in range(num_clusters)]
                self.configs = [EC.HybridUintConfig.read(br, log_alpha)
                                for _ in range(num_clusters)]
            self.prefix_codes = [read_prefix_code(br, s) for s in sizes]
            self.ans = None
        else:
            self.configs = [EC.HybridUintConfig.read(br, log_alpha)
                            for _ in range(num_clusters)]
            dists = [_ans.read_ans_distribution(br, log_alpha)
                     for _ in range(num_clusters)]
            self.alias_tables = [AliasTable(d, log_alpha) for d in dists]
            self.ans = AnsState(br)
        self._copy_pos = 0
        self._copy_len = 0
        self.num_decoded = 0


def main():
    import refjxl
    from jxl_coder import api

    EC_orig = EC.EntropyDecoder
    streams = []
    img1 = np.zeros((1, 1, 3), np.uint8)
    img1[0, 0] = (200, 100, 50)
    rng = np.random.default_rng(0)
    img16 = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
    for e in (1, 3, 7):
        streams.append((f"1x1-e{e}", refjxl.encode(img1, True, e), img1))
        streams.append((f"16x16-e{e}", refjxl.encode(img16, True, e), img16))

    keys = list(VARIANTS)
    results = []
    for combo in itertools.product(*(VARIANTS[k] for k in keys)):
        CURRENT.update(dict(zip(keys, combo)))
        # monkeypatch everywhere EntropyDecoder is referenced
        EC.EntropyDecoder = EntropyDecoderV
        import jxl_coder.modular.tree as MT
        import jxl_coder.modular.stream as MS
        MT.EntropyDecoder = EntropyDecoderV
        MS.EntropyDecoder = EntropyDecoderV
        score = 0
        detail = []
        for name, data, img in streams:
            try:
                out, _ = api.decode(data)
                ok = out.shape == img.shape and np.array_equal(out, img)
                if ok:
                    score += 10
                    detail.append(f"{name}:OK")
                else:
                    score += 3
                    detail.append(f"{name}:pix")
            except Exception as ex:
                detail.append(f"{name}:{type(ex).__name__[:12]}")
        results.append((score, dict(CURRENT), detail))
    results.sort(key=lambda r: -r[0])
    for score, combo, detail in results[:8]:
        print(score, combo, detail)


if __name__ == "__main__":
    main()
