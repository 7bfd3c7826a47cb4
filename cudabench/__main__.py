import sys

from cudabench.harness import main

sys.exit(main())
