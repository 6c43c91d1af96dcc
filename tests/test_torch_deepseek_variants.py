"""The deepseek-moe-16b chain of ``test_torch_deepseek.py`` (both packages
compress the same bridged SMOKE model, cut to 1 layer, f32; the port
packs the bridged reference decompositions byte-identically and serves
them with the reference's logits and tokens) for the methods whose
experts run the grouped kernels #13, #18 and #19:

- hassle, CR 0.5 -> lowrank-ell (#5 and #13);
- hassle, CR 0.5 2:4 -> lowrank-nm (#7 and #19);
- slab W_S + W_L (no binary), CR 0.2 -> lowrank-dense (#6 and #18): at
  f32 ELL loses on bytes from K_max = 2K/3 on, which a keep fraction of
  about 0.77 passes.

A file of its own so that the test runner's workers take the two halves
of the chain at once.
"""
import pytest

from test_torch_deepseek import (Chain, build_models, check_decs_match,
                                 check_pack_byte_identical, check_serving)

METHODS = {  # name -> (method, SLaBConfig fields, variant)
    "hassle": ("hassle", dict(cr=0.5, iters=2), "lowrank-ell"),
    "hassle-2:4": ("hassle", dict(cr=0.5, iters=2, pattern="2:4"),
                   "lowrank-nm"),
    "slab-w_s+w_l": ("slab", dict(cr=0.2, iters=1, include_binary=False),
                     "lowrank-dense"),
}


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module", params=list(METHODS))
def chain(request, models):
    method, kw, variant = METHODS[request.param]
    return variant, Chain(models, method, kw)


def test_compress_model_decs_match_reference(chain):
    check_decs_match(chain[1])


def test_pack_model_byte_identical_to_reference(chain):
    variant, c = chain
    check_pack_byte_identical(c, variant)


def test_packed_serving_matches_reference(chain):
    check_serving(chain[1])
