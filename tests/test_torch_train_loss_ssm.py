"""``model_api.loss_fn`` and its gradients against the JAX package's for
the reduced ssm (mamba2), hybrid (zamba2) and audio (whisper) configs, as
``test_torch_train_loss.py`` holds the other families (its docstring gives
the tolerances)."""
import pytest

pytest.importorskip("torch")

from test_torch_train_loss import check_loss_and_gradients


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b",
                                  "whisper-medium"])
def test_loss_and_gradients_match_reference(arch):
    check_loss_and_gradients(arch)
