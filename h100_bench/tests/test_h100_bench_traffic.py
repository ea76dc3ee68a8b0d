"""The request generator: the seed decides the content and nothing else; the
mix decides the shapes."""

import filecmp

from h100_bench import harness, requests

MIX = harness.load_json(harness.BENCH, "mixes", "edit-512.json")


def _pool(tmp_path, seed, name):
    return requests.make_pool(dict(MIX, pool=8), seed, str(tmp_path / name))


def test_same_seed_same_requests(tmp_path):
    a, b = _pool(tmp_path, 2 ** 31 + 5, "a"), _pool(tmp_path, 2 ** 31 + 5, "b")
    for x, y in zip(a, b):
        assert (x.words, x.noise_seed, x.size) == (y.words, y.noise_seed, y.size)
        for p, q in ((x.scene, y.scene), (x.mask, y.mask), (x.words_file, y.words_file)):
            assert filecmp.cmp(p, q, shallow=False)


def test_other_seed_other_content_same_shapes(tmp_path):
    a, b = _pool(tmp_path, 11, "a"), _pool(tmp_path, 2 ** 32 + 11, "b")
    assert [x.size for x in a] == [x.size for x in b]
    assert [x.words for x in a] != [x.words for x in b]
    assert [x.noise_seed for x in a] != [x.noise_seed for x in b]
    assert not filecmp.cmp(a[0].scene, b[0].scene, shallow=False)


def test_the_cycle_of_canvas_shapes():
    sizes = [requests.scene_size(MIX, i) for i in range(8)]
    assert sizes[:4] == [(512, 288), (384, 512), (512, 384), (512, 512)]
    assert sizes[4:] == sizes[:4]


def test_words_are_one_line_of_one_to_four_words(tmp_path):
    for r in _pool(tmp_path, 3, "a"):
        with open(r.words_file) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        assert len(lines) == 1 and r.words == (lines[0],)
        assert 1 <= len(lines[0].split()) <= 4
