"""Command-line tools of the port (``python -m bdvcil_torch.cil_tools.<tool>``).

  train_cil           the CIL training entry point
  test_cil, test_single_ckpt, predict, extract_features, extract_background
                      not ported yet: each raises NotImplementedError naming
                      ROADMAP A.7 (``CILTrainer.cil_testing`` and
                      ``single_ckpt_testing`` themselves are ported)
"""

DEFERRED_TOOLS = ("test_cil", "test_single_ckpt", "predict", "extract_features",
                  "extract_background")


def deferred_tool(name: str):
    """The ``main`` of a tool that waits for ROADMAP A.7."""

    def main(argv=None):
        raise NotImplementedError(f"bdvcil_torch.cil_tools.{name} is not ported yet "
                                  f"(ROADMAP A.7; cil_tools/{name}.py is the JAX tool)")

    return main
