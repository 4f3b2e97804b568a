"""small-media's forward variant (fog with a transparency cube and a
thinsheet orb) through the lockstep forward branch, its volume NEE and its
crossing walks with media, against the JAX render at equal seed (the bars
and helpers of test_torch_media_render.py)."""
import pytest

from test_torch_lockstep_area import one_torch_thread  # noqa: F401
from test_torch_media_render import check_means_file, check_media_render, media_case, ref  # noqa: F401


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return {"forward": media_case("forward", str(tmp_path_factory.mktemp("forward")))}


def test_forward_render_matches_jax(cases, ref):  # noqa: F811
    check_media_render(cases, ref, "forward", "lockstep")


def test_reference_means_file_matches(cases, ref):  # noqa: F811
    check_means_file(cases, ref, ["forward"])
