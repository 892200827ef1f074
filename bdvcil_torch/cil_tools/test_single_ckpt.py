"""Test one checkpoint (the counterpart of cil_tools/test_single_ckpt.py): not ported yet, ROADMAP A.7."""

from . import deferred_tool

main = deferred_tool("test_single_ckpt")

if __name__ == "__main__":
    main()
